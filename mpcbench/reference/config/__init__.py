"""Mission and MPC YAML loaders and the offline reference reader: the
port's own host front end (no import of the JAX package)."""

from .refs import load_ref, ref_path, synthetic_ref
from .specs import load_mpc_params, load_trajectory

__all__ = ["load_mpc_params", "load_trajectory", "load_ref", "ref_path",
           "synthetic_ref"]
