"""Cost slots, activations and the STATE, CONTROL and operational-frame
residuals, and the friction cone's matrix (counterpart of
``eagle_mpc_tpu.ocp.costs``; the cone's residual needs the contact forces
and is evaluated in ``problem``).

Cost = weight * a(r(x, u)) with Gauss-Newton derivatives
L = w * (R' Ar, R' diag(Arr) R), as in Crocoddyl.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..dynamics import lie, rbd

# slot kinds
STATE = "state"
CONTROL = "control"
FRAME_PLACEMENT = "frame_placement"
FRAME_TRANSLATION = "frame_translation"
FRAME_ROTATION = "frame_rotation"
FRAME_VELOCITY = "frame_velocity"
FRICTION_CONE = "friction_cone"

#: kinds this package evaluates
SUPPORTED_KINDS = (STATE, CONTROL, FRAME_PLACEMENT, FRAME_TRANSLATION,
                   FRAME_ROTATION, FRAME_VELOCITY, FRICTION_CONE)

#: reference sizes of the frame kinds
REF_DIMS = {
    FRAME_PLACEMENT: 7,     # p (3) + quat (4)
    FRAME_TRANSLATION: 3,
    FRAME_ROTATION: 4,      # quat
    FRAME_VELOCITY: 6,      # [linear, angular] LOCAL
}
_POSE_KINDS = (FRAME_PLACEMENT, FRAME_TRANSLATION, FRAME_ROTATION)

# activation kinds
QUAD = "quad"
WQUAD = "wquad"
QBARRIER = "qbarrier"
WQBARRIER = "wqbarrier"

ACTIVATIONS = (QUAD, WQUAD, QBARRIER, WQBARRIER)


class CostSlot(NamedTuple):
    """Static description of one cost channel shared by all nodes (same
    fields as the reference package's ``CostSlot``)."""

    name: str
    kind: str
    activation: str
    nr: int
    ref_dim: int
    frame_id: int = -1
    contact_id: int = -1
    cone_A: Optional[Tuple[Tuple[float, ...], ...]] = None


def friction_cone_matrix(n_surf, mu: float) -> np.ndarray:
    """Rows A (5, 3) of the 4-facet outer linearized friction cone and the
    normal-force row, A f >= 0 inside the cone (Crocoddyl's
    ``FrictionCone(n_surf, mu, 4, false)``, which the reference hardcodes)."""
    n = np.asarray(n_surf, dtype=np.float64)
    n = n / np.linalg.norm(n)
    t1 = np.cross(n, [1.0, 0.0, 0.0])
    if np.linalg.norm(t1) < 1e-6:
        t1 = np.cross(n, [0.0, 1.0, 0.0])
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    rows = []
    for tv in (t1, t2):
        rows.append(mu * n - tv)
        rows.append(mu * n + tv)
    rows.append(n)
    return np.stack(rows)


def activation(kind: str, r, w, lb, ub):
    """(a (...), Ar (..., nr), Arr (..., nr)) over the last axis of r."""
    if kind == QUAD:
        return 0.5 * torch.sum(r * r, dim=-1), r, torch.ones_like(r)
    if kind == WQUAD:
        wr = w * r
        return 0.5 * torch.sum(wr * r, dim=-1), wr, w.expand_as(r)
    if kind in (QBARRIER, WQBARRIER):
        viol = torch.clamp(r - lb, max=0.0) + torch.clamp(r - ub, min=0.0)
        mask = (viol != 0.0).to(r.dtype)
        if kind == QBARRIER:
            return 0.5 * torch.sum(viol * viol, dim=-1), viol, mask
        return 0.5 * torch.sum(w * viol * viol, dim=-1), w * viol, w * mask
    raise ValueError(f"unknown activation kind {kind}")


class FkCache(NamedTuple):
    """Forward kinematics at one evaluation point, shared by its frame
    slots: per-body world poses and local velocities (None where no slot
    needs them)."""

    pw: Optional[list] = None    # per-body world translation
    Rw: Optional[list] = None    # per-body world rotation
    vel: Optional[list] = None   # per-body local spatial velocity


def build_fk_cache(model, slots, q, v) -> FkCache:
    pw = Rw = vel = None
    if any(s.kind in _POSE_KINDS for s in slots):
        pw, Rw = rbd.body_world_placements(model, q)
    if any(s.kind == FRAME_VELOCITY for s in slots):
        vel = rbd.body_velocities(model, q, v)
    return FkCache(pw, Rw, vel)


def residual(model, state, slot: CostSlot, ref, cache: FkCache, x, u):
    """Residual of one slot at (x, u) with ``cache`` built at x; ``u`` is
    the pre-squash control."""
    if slot.kind == STATE:
        return state.diff(ref, x)
    if slot.kind == CONTROL:
        return u - ref
    if slot.kind == FRAME_VELOCITY:
        return rbd.frame_velocity_from(model, slot.frame_id, cache.vel) - ref
    if slot.kind not in _POSE_KINDS:
        raise NotImplementedError(f"cost kind {slot.kind!r} is not ported yet")
    p, R = rbd.frame_pose_from(model, slot.frame_id, cache.pw, cache.Rw)
    if slot.kind == FRAME_TRANSLATION:
        return p - ref
    if slot.kind == FRAME_ROTATION:
        return lie.log3(lie.quat_to_rot(ref).transpose(-1, -2) @ R)
    RrefT = lie.quat_to_rot(ref[..., 3:7]).transpose(-1, -2)
    return lie.log6(lie.matvec(RrefT, p - ref[..., :3]),
                    lie.rot_to_quat(RrefT @ R))
