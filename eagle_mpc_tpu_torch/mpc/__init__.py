"""MPC controllers."""

from .base import MpcAbstract
from .carrot import CarrotMpc
from .rail import RailMpc
from .weighted import WeightedMpc

__all__ = ["MpcAbstract", "CarrotMpc", "RailMpc", "WeightedMpc"]
