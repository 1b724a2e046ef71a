"""Spatial (6-D) vector algebra, PyTorch counterpart of
``eagle_mpc_tpu.dynamics.spatial``.

Motion vectors are ``[linear; angular]``, force vectors ``[force; torque]``,
every quantity of a body is in that body's local frame, and a pose (p, R)
of frame C in frame P maps C-coordinates into P-coordinates. Leading batch
dims broadcast.
"""

from __future__ import annotations

import torch

from .lie import cross, matvec


def _mT(R):
    return R.transpose(-1, -2)


def motion_to_parent(p, R, m):
    """v_P = R v_C + p x (R w_C)."""
    v, w = m[..., :3], m[..., 3:]
    Rw = matvec(R, w)
    return torch.cat([matvec(R, v) + cross(p, Rw), Rw], dim=-1)


def motion_to_child(p, R, m):
    """Inverse of :func:`motion_to_parent`."""
    v, w = m[..., :3], m[..., 3:]
    Rt = _mT(R)
    return torch.cat([matvec(Rt, v - cross(p, w)), matvec(Rt, w)], dim=-1)


def force_to_parent(p, R, f):
    """f_P = R f_C ; tau_P = R tau_C + p x (R f_C)."""
    fo, tau = f[..., :3], f[..., 3:]
    Rf = matvec(R, fo)
    return torch.cat([Rf, matvec(R, tau) + cross(p, Rf)], dim=-1)


def force_to_child(p, R, f):
    """Inverse of :func:`force_to_parent`."""
    fo, tau = f[..., :3], f[..., 3:]
    Rt = _mT(R)
    return torch.cat([matvec(Rt, fo), matvec(Rt, tau - cross(p, fo))], dim=-1)


def motion_cross(m1, m2):
    """Spatial cross product ad_{m1} m2."""
    v1, w1 = m1[..., :3], m1[..., 3:]
    v2, w2 = m2[..., :3], m2[..., 3:]
    return torch.cat([cross(w1, v2) + cross(v1, w2), cross(w1, w2)], dim=-1)


def motion_cross_force(m, f):
    """Dual cross product ad*_{m} f."""
    v, w = m[..., :3], m[..., 3:]
    fo, tau = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fo), cross(w, tau) + cross(v, fo)], dim=-1)
