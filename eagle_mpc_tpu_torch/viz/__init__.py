"""Visualization: the matplotlib plot suite and the 3-D multicopter
display (counterpart of ``eagle_mpc_tpu.viz``)."""

from . import plots
from .visualizer import MulticopterDisplay, rotor_geometry

__all__ = ["plots", "MulticopterDisplay", "rotor_geometry"]
