"""Host utilities: leveled logging, mission tools and platform presets."""

from . import aerial_manipulation, tools
from .aerial_manipulation import hexarotor370_params, hexarotor680_params

__all__ = ["tools", "aerial_manipulation",
           "hexarotor370_params", "hexarotor680_params"]
