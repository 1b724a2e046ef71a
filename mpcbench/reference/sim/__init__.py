"""The plant simulator."""

from .plant import AerialSimulator

__all__ = ["AerialSimulator"]
