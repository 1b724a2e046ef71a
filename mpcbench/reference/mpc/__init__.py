"""The Carrot MPC controller."""

from .base import MpcAbstract
from .carrot import CarrotMpc

__all__ = ["MpcAbstract", "CarrotMpc"]
