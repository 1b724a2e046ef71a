"""Lie-group primitives: quaternions, SO(3) and SE(3) exp/log maps.

PyTorch counterpart of ``eagle_mpc_tpu.dynamics.lie`` with the same
conventions (Pinocchio's):

- quaternions are stored ``(x, y, z, w)``;
- the free-flyer tangent is a local twist ``[v, w]``, linear part first;
- ``exp6`` / ``log6`` are the coupled SE(3) exponential and logarithm.

Every function takes tensors with any leading batch shape and keeps the
small-angle Taylor guards of the reference, written as ``torch.where`` on
guarded operands so forward-mode derivatives stay finite at the identity.
"""

from __future__ import annotations

import torch

# Threshold below which Taylor expansions replace the closed forms.
_EPS2 = 1e-8


def _safe_nonzero(x):
    """x where it is large enough, else 1 (keeps derivatives finite)."""
    return torch.where(x < _EPS2, torch.ones_like(x), x)


def cross(a, b):
    """a x b over the last axis; leading dims broadcast."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def matvec(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product; R(q1 * q2) = R(q1) @ R(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q, v):
    """Rotate v by q."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_to_rot(q):
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R):
    """3x3 rotation matrix -> unit quaternion (x, y, z, w): branch-free
    Shepperd, the candidate of the largest diagonal term (first on ties)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(a, b, c, d, s):
        # s = 4 q_k^2, > 0 on the branch that is kept
        return (torch.stack([a, b, c, d], dim=-1)
                / torch.sqrt(_safe_nonzero(s)).unsqueeze(-1))

    s_w = 1.0 + tr
    s_x = 1.0 + m00 - m11 - m22
    s_y = 1.0 - m00 + m11 - m22
    s_z = 1.0 - m00 - m11 + m22
    qs = torch.stack([
        cand(m21 - m12, m02 - m20, m10 - m01, s_w, s_w),
        cand(s_x, m01 + m10, m02 + m20, m21 - m12, s_x),
        cand(m01 + m10, s_y, m12 + m21, m02 - m20, s_y),
        cand(m02 + m20, m12 + m21, s_z, m10 - m01, s_z)], dim=-2)
    idx = torch.argmax(torch.stack([s_w, s_x, s_y, s_z], dim=-1), dim=-1)
    q = torch.take_along_dim(qs, idx[..., None, None], dim=-2)[..., 0, :]
    return quat_normalize(q * 0.5)


def quat_exp(w):
    """Rotation vector -> unit quaternion."""
    t2 = torch.sum(w * w, dim=-1, keepdim=True)
    t = torch.sqrt(_safe_nonzero(t2))
    small = t2 < _EPS2
    sinc_half = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * t) / t)
    cos_half = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))
    return torch.cat([w * sinc_half, cos_half], dim=-1)


def quat_log(q):
    """Unit quaternion -> rotation vector, on the shortest path."""
    sign = torch.where(q[..., 3:] >= 0, 1.0, -1.0).to(q.dtype)
    qv = q[..., :3] * sign
    qw = q[..., 3] * sign[..., 0]
    n2 = torch.sum(qv * qv, dim=-1)
    n = torch.sqrt(_safe_nonzero(n2))
    angle = 2.0 * torch.atan2(n, qw)
    qw_safe = torch.clamp(qw, min=0.5)
    small_scale = 2.0 / qw_safe * (1.0 - n2 / (3.0 * qw_safe * qw_safe))
    scale = torch.where(n2 < _EPS2, small_scale, angle / n)
    return qv * scale.unsqueeze(-1)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w):
    """R^3 -> so(3) skew matrix."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z],
                       dim=-1).reshape(w.shape[:-1] + (3, 3))


def exp3(w):
    """Rotation vector -> rotation matrix (Rodrigues)."""
    t2 = torch.sum(w * w, dim=-1)
    t2s = _safe_nonzero(t2)
    t = torch.sqrt(t2s)
    small = t2 < _EPS2
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log3(R):
    """Rotation matrix -> rotation vector, through the quaternion (the
    short way round, derivatives finite at the identity)."""
    return quat_log(rot_to_quat(R))


# ---------------------------------------------------------------------------
# SE(3): poses as (p, quat)
# ---------------------------------------------------------------------------

def exp6(xi):
    """Twist [v, w] -> (p, quat); p = V(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(w * w, dim=-1)
    t2s = _safe_nonzero(t2)
    t = torch.sqrt(t2s)
    small = t2 < _EPS2
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    W = hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return matvec(V, v), quat_exp(w)


def log6(p, q):
    """(p, quat) -> twist [v, w]; inverse of exp6."""
    w = quat_log(q)
    t2 = torch.sum(w * w, dim=-1)
    t2s = _safe_nonzero(t2)
    t = torch.sqrt(t2s)
    small = t2 < _EPS2
    half = 0.5 * t
    d = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.sin(torch.where(small, torch.ones_like(half), half))) / t2s)
    W = hat(w)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    Vinv = eye - 0.5 * W + d[..., None, None] * (W @ W)
    return torch.cat([matvec(Vinv, p), w], dim=-1)


def se3_mul(p1, q1, p2, q2):
    """Compose two poses: M1 * M2."""
    return p1 + quat_rotate(q1, p2), quat_normalize(quat_mul(q1, q2))


def se3_inv(p, q):
    qi = quat_conj(q)
    return -quat_rotate(qi, p), qi


def se3_interpolate(p0, q0, p1, q1, alpha):
    """Geodesic interpolation M0 * exp6(alpha * log6(M0^-1 M1));
    ``alpha`` broadcasts against the leading dims."""
    pi, qi = se3_inv(p0, q0)
    dp, dq = se3_mul(pi, qi, p1, q1)
    xi = log6(dp, dq)
    ep, eq = exp6(alpha.unsqueeze(-1) * xi)
    return se3_mul(p0, q0, ep, eq)
