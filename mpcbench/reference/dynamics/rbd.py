"""Free-flyer rigid-body dynamics: RNEA, CRBA and forward dynamics.

PyTorch counterpart of ``eagle_mpc_tpu.dynamics.rbd``: free and
contact-constrained dynamics, frame kinematics and the energies.
The kinematic tree is the port's ``RobotModel`` (``dynamics.model``); its
constants are turned into tensors once per (model, device, dtype).
Every function takes (..., nq) / (..., nv) tensors with any leading batch
shape; the per-joint loops run in Python over the static tree.

Forward dynamics is mass-matrix based (CRBA + Cholesky), as in the
reference, so forward-mode derivatives (``torch.func``) go through the
factorization; the derivative is the same as the reference's implicit-
function-theorem rule, ``da = M^-1 (dtau - d rnea|_a)``. The contact
dynamics go through both factorizations (M's and the Schur complement's)
the same way, which gives the reference's IFT rule for the KKT system.
Where the reference nests forward mode (the frame drift as a jvp along
qdot, linearized again by the node derivatives), the port computes the
inner derivative in closed form, so torch's single forward-mode level is
enough.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import torch

from ..ops import smallmat
from . import lie, spatial
from .model import PRISMATIC, REVOLUTE, RobotModel


class ModelTensors(NamedTuple):
    joint_p: torch.Tensor      # (nj, 3)
    joint_R: torch.Tensor      # (nj, 3, 3)
    joint_axis: torch.Tensor   # (nj, 3)
    inertia: torch.Tensor      # (nj+1, 6, 6)
    gravity: torch.Tensor      # (6,) base pseudo-acceleration in the world


@functools.lru_cache(maxsize=64)
def model_tensors(model: RobotModel, device, dtype) -> ModelTensors:
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return ModelTensors(
        joint_p=t(model.joint_p).reshape(model.nj, 3),
        joint_R=t(model.joint_R).reshape(model.nj, 3, 3),
        joint_axis=t(model.joint_axis).reshape(model.nj, 3),
        inertia=t(model.inertia),
        gravity=t([0.0, 0.0, model.gravity]))


def _joint_kinematics(model: RobotModel, mt: ModelTensors, j: int, qj):
    """Pose (p, R) of body j+1 in its parent and its motion subspace S."""
    jp, jR, axis = mt.joint_p[j], mt.joint_R[j], mt.joint_axis[j]
    zero3 = torch.zeros_like(axis)
    if model.joint_type[j] == REVOLUTE:
        R = jR @ lie.exp3(axis * qj.unsqueeze(-1))
        p = jp.expand(R.shape[:-2] + (3,))
        S = torch.cat([zero3, axis])
    elif model.joint_type[j] == PRISMATIC:
        p = jp + lie.matvec(jR, axis * qj.unsqueeze(-1))
        R = jR.expand(p.shape[:-1] + (3, 3))
        S = torch.cat([axis, zero3])
    else:  # pragma: no cover
        raise NotImplementedError(model.joint_type[j])
    return p, R, S


def _tree_kinematics(model: RobotModel, mt: ModelTensors, q, v):
    """Per-body (p, R) in the parent, subspaces and local velocities."""
    nj = model.nj
    Xp: List = [None] * (nj + 1)
    Xr: List = [None] * (nj + 1)
    S: List = [None] * (nj + 1)
    vel: List = [None] * (nj + 1)
    vel[0] = v[..., :6]
    for j in range(nj):
        b = j + 1
        Xp[b], Xr[b], S[b] = _joint_kinematics(model, mt, j, q[..., 7 + j])
        vel[b] = (spatial.motion_to_child(Xp[b], Xr[b], vel[model.parent[j]])
                  + S[b] * v[..., 6 + j:7 + j])
    return Xp, Xr, S, vel


def rnea(model: RobotModel, q, v, a):
    """Inverse dynamics: tau = [base wrench (6, local), joint torques] such
    that the tree undergoes ``a`` under gravity."""
    mt = model_tensors(model, q.device, q.dtype)
    nj = model.nj
    Xp, Xr, S, vel = _tree_kinematics(model, mt, q, v)

    acc: List = [None] * (nj + 1)
    g = lie.quat_rotate_inv(q[..., 3:7], mt.gravity.expand(q.shape[:-1] + (3,)))
    acc[0] = a[..., :6] + torch.cat([g, torch.zeros_like(g)], dim=-1)
    for j in range(nj):
        b = j + 1
        Svdot = S[b] * v[..., 6 + j:7 + j]
        acc[b] = (spatial.motion_to_child(Xp[b], Xr[b], acc[model.parent[j]])
                  + S[b] * a[..., 6 + j:7 + j]
                  + spatial.motion_cross(vel[b], Svdot))

    force: List = [None] * (nj + 1)
    for b in range(nj + 1):
        I6 = mt.inertia[b]
        force[b] = (lie.matvec(I6, acc[b])
                    + spatial.motion_cross_force(vel[b], lie.matvec(I6, vel[b])))

    tau_j: List = [None] * nj
    for j in reversed(range(nj)):
        b = j + 1
        tau_j[j] = torch.sum(S[b] * force[b], dim=-1, keepdim=True)
        parent = model.parent[j]
        force[parent] = force[parent] + spatial.force_to_parent(Xp[b], Xr[b], force[b])
    return torch.cat([force[0]] + tau_j, dim=-1)


def bias_force(model: RobotModel, q, v):
    """Nonlinear effects b(q, v): gravity + Coriolis/centrifugal."""
    return rnea(model, q, v, torch.zeros_like(v))


def _xform_p2c(p, R):
    """6x6 motion transform parent -> child."""
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ lie.hat(p)], dim=-1)
    bot = torch.cat([torch.zeros_like(Rt), Rt], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crba(model: RobotModel, q):
    """Composite rigid-body algorithm: joint-space mass matrix (..., nv, nv)."""
    mt = model_tensors(model, q.device, q.dtype)
    nj, nv = model.nj, model.nv
    batch = q.shape[:-1]
    Xp, Xr, S, _ = _tree_kinematics(model, mt, q,
                                    torch.zeros(batch + (nv,), dtype=q.dtype,
                                                device=q.device))
    Ic: List = [mt.inertia[b].expand(batch + (6, 6)) for b in range(nj + 1)]
    for j in reversed(range(nj)):
        b = j + 1
        X = _xform_p2c(Xp[b], Xr[b])
        Ic[model.parent[j]] = Ic[model.parent[j]] + X.transpose(-1, -2) @ Ic[b] @ X
    if nj == 0:
        return Ic[0]

    ent = {}         # (6+j, 6+jj) strict-lower joint-joint entries
    base_cols = {}   # row 6+j -> (..., 6) base-coupling block
    for j in range(nj):
        b = j + 1
        F = lie.matvec(Ic[b], S[b].expand(batch + (6,)))
        ent[(6 + j, 6 + j)] = torch.sum(S[b] * F, dim=-1)
        body = b
        while body != 0:
            F = spatial.force_to_parent(Xp[body], Xr[body], F)
            body = model.parent[body - 1]
            if body != 0:
                ent[(6 + j, 6 + body - 1)] = torch.sum(S[body] * F, dim=-1)
        base_cols[6 + j] = F

    zero = torch.zeros(batch, dtype=q.dtype, device=q.device)

    def entry(i, c):
        if i < 6 and c < 6:
            return Ic[0][..., i, c]
        if i >= 6 and c < 6:
            return base_cols[i][..., c]
        if i < 6:
            return base_cols[c][..., i]
        return ent.get((max(i, c), min(i, c)), zero)

    rows = [torch.stack([entry(i, c) for c in range(nv)], dim=-1)
            for i in range(nv)]
    return torch.stack(rows, dim=-2)


def fwd_dynamics(model: RobotModel, q, v, tau):
    """a = M(q)^{-1} (tau - b(q, v)) via Cholesky (NaN where M is not PD)."""
    return smallmat.solve_psd(crba(model, q), tau - bias_force(model, q, v))


# ---------------------------------------------------------------------------
# Frame kinematics (operational-space costs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def frame_tensors(model: RobotModel, frame_id: int, device, dtype):
    """(p, R) of an operational frame in its body, as tensors."""
    f = model.frames[frame_id]
    return (torch.as_tensor(f.p, dtype=dtype, device=device),
            torch.as_tensor(f.R, dtype=dtype, device=device))


def body_world_placements(model: RobotModel, q):
    """World pose (p, R) of every body frame: two lists of nj+1 tensors."""
    mt = model_tensors(model, q.device, q.dtype)
    pw: List = [q[..., :3]]
    Rw: List = [lie.quat_to_rot(q[..., 3:7])]
    for j in range(model.nj):
        p, R, _ = _joint_kinematics(model, mt, j, q[..., 7 + j])
        parent = model.parent[j]
        pw.append(pw[parent] + lie.matvec(Rw[parent], p))
        Rw.append(Rw[parent] @ R)
    return pw, Rw


def frame_pose_from(model: RobotModel, frame_id: int, pw, Rw):
    """World pose (p, R) of an operational frame from the bodies' poses."""
    fp, fR = frame_tensors(model, frame_id, pw[0].device, pw[0].dtype)
    b = model.frames[frame_id].body
    return pw[b] + lie.matvec(Rw[b], fp), Rw[b] @ fR


def frame_placement(model: RobotModel, q, frame_id: int):
    """World pose (p, R) of an operational frame."""
    return frame_pose_from(model, frame_id, *body_world_placements(model, q))


def body_velocities(model: RobotModel, q, v):
    """Local spatial velocity of every body: a list of nj+1 tensors."""
    return _tree_kinematics(model, model_tensors(model, q.device, q.dtype),
                            q, v)[3]


def frame_velocity_from(model: RobotModel, frame_id: int, vel):
    """Spatial velocity of a frame expressed in the frame (LOCAL), from the
    bodies' local velocities."""
    fp, fR = frame_tensors(model, frame_id, vel[0].device, vel[0].dtype)
    return spatial.motion_to_child(fp, fR, vel[model.frames[frame_id].body])


def frame_velocity(model: RobotModel, q, v, frame_id: int):
    """Spatial velocity of a frame, expressed in the frame (LOCAL)."""
    return frame_velocity_from(model, frame_id, body_velocities(model, q, v))


# ---------------------------------------------------------------------------
# Contact dynamics (KKT-constrained forward dynamics)
# ---------------------------------------------------------------------------

def frame_jacobian_local(model: RobotModel, q, frame_id: int):
    """LOCAL-frame Jacobian J (..., 6, nv): v_frame = J v. The frame
    velocity is linear in v, so column i is the velocity at v = e_i, all
    nv of them in one batched evaluation."""
    nv = model.nv
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    qq = q.unsqueeze(-2).expand(q.shape[:-1] + (nv, q.shape[-1]))
    cols = frame_velocity(model, qq, eye.expand(q.shape[:-1] + (nv, nv)),
                          frame_id)
    return cols.transpose(-1, -2)


def frame_accel_drift(model: RobotModel, q, v, frame_id: int):
    """Spatial acceleration of a frame at zero joint acceleration (the
    J-dot v drift), expressed in the frame (LOCAL): the time derivative of
    the frame's local velocity as q moves along v with v held. In closed
    form, the forward pass of RNEA without gravity at zero acceleration:
    a_0 = 0, a_i = X_i a_parent + v_i x (S_i qd_i), moved to the frame."""
    mt = model_tensors(model, q.device, q.dtype)
    Xp, Xr, S, vel = _tree_kinematics(model, mt, q, v)
    acc: List = [torch.zeros_like(v[..., :6])]
    for j in range(model.nj):
        b = j + 1
        acc.append(spatial.motion_to_child(Xp[b], Xr[b], acc[model.parent[j]])
                   + spatial.motion_cross(vel[b], S[b] * v[..., 6 + j:7 + j]))
    fp, fR = frame_tensors(model, frame_id, q.device, q.dtype)
    return spatial.motion_to_child(fp, fR, acc[model.frames[frame_id].body])


def contact_fwd_dynamics(model: RobotModel, q, v, tau, J_rows, a0_rows,
                         active, damping: float = 0.0):
    """Constrained forward dynamics with per-row activity masks: solves
    M a + b = tau + Jm' lam, Jm a + active a0 = 0 with Jm = active J. The
    masked Schur complement G = Jm M^-1 Jm' + diag(1 - active) + damping I
    gives lam = 0 on inactive rows, so an all-inactive node is free
    dynamics exactly. J_rows (..., nc, nv), a0_rows and active (..., nc).
    Returns (a, lam); NaN where M or G is not positive definite."""
    chol = smallmat.CholFactor(crba(model, q))
    free_acc = chol.solve(tau - bias_force(model, q, v))
    Jm = active.unsqueeze(-1) * J_rows
    MinvJt = chol.solve_mat(Jm.transpose(-1, -2))          # (..., nv, nc)
    nc = J_rows.shape[-2]
    eye = torch.eye(nc, dtype=q.dtype, device=q.device)
    G = (Jm @ MinvJt + torch.diag_embed(1.0 - active) + damping * eye)
    rhs = lie.matvec(Jm, free_acc) + active * a0_rows
    lam = -smallmat.solve_psd(G, rhs)
    return free_acc + lie.matvec(MinvJt, lam), lam


# ---------------------------------------------------------------------------
# Energies (diagnostics)
# ---------------------------------------------------------------------------

def kinetic_energy(model: RobotModel, q, v):
    """0.5 v' M(q) v."""
    return 0.5 * torch.sum(v * lie.matvec(crba(model, q), v), dim=-1)


def potential_energy(model: RobotModel, q):
    """Sum over bodies of m g z_com (world frame)."""
    mt = model_tensors(model, q.device, q.dtype)
    pw, Rw = body_world_placements(model, q)
    e = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    for b in range(model.nj + 1):
        I6 = mt.inertia[b]
        m = I6[0, 0]
        # I6[3:, :3] = m hat(com): its skew components
        mc = torch.stack([I6[5, 1], I6[3, 2], I6[4, 0]])
        com = mc / m if float(m) > 0 else torch.zeros_like(mc)
        e = e + m * model.gravity * (pw[b] + lie.matvec(Rw[b], com))[..., 2]
    return e
