"""Actuation and control squashing (counterpart of
``eagle_mpc_tpu.ocp.actuation``)."""

from __future__ import annotations

import torch


def actuation_tau(tau_f, u):
    """u = [rotor thrusts, joint torques] -> tau = [tau_f @ thrusts (6-D base
    wrench, local frame), joint torques]. ``tau_f``: (6, n_rotors)."""
    n_rotors = tau_f.shape[1]
    base = u[..., :n_rotors] @ tau_f.transpose(0, 1)
    return torch.cat([base, u[..., n_rotors:]], dim=-1)


def smooth_sat(s, lb, ub, smooth):
    """Smooth box clamp u = squash(s); ``smooth`` sets the corner radius
    and broadcasts against the leading dims of ``s``."""
    d = smooth * (ub - lb)
    a = d * d
    return 0.5 * (torch.sqrt(a + (s - lb) ** 2) - torch.sqrt(a + (s - ub) ** 2)
                  + lb + ub)


def barrier_quad_weights(s_lb, s_ub, smooth):
    """Activation weights of the squash-barrier cost: 1 / (smooth*(ub-lb))^2."""
    d = smooth * (s_ub - s_lb)
    return 1.0 / (d * d)
