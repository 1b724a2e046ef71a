"""State manifold SE(3) x R^n, PyTorch counterpart of
``eagle_mpc_tpu.dynamics.state``.

    x = [ p (3), quat (x,y,z,w) (4), q_joints (nj) | v_lin, omega, qdot ]

Base velocities are in the body frame; ``diff``/``integrate`` use the
coupled SE(3) log/exp for the base, as ``pinocchio::difference`` and
``pinocchio::integrate`` do for a free-flyer joint. Leading batch dims
broadcast.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie


class State(NamedTuple):
    nq: int
    nv: int

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def ndx(self) -> int:
        return 2 * self.nv

    @property
    def nj(self) -> int:
        return self.nq - 7

    def zero(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """The origin: zero position, identity attitude, zero joints and
        velocities (nx,)."""
        x = torch.zeros(self.nx, dtype=dtype, device=device)
        x[6] = 1.0
        return x

    def rand(self, rng: np.random.Generator, dtype=torch.float64,
             device=None) -> torch.Tensor:
        """A random state (nx,) with a unit quaternion, drawn from the numpy
        generator as the JAX package draws it (a seed gives the same state
        in both)."""
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        x = rng.normal(size=self.nx)
        x[3:7] = q
        return torch.as_tensor(x, dtype=dtype, device=device)

    def integrate(self, x, dx):
        """x (+) dx with dx = [xi_base (6), dq_joints, dv (nv)]."""
        p2, q2 = lie.se3_mul(x[..., :3], x[..., 3:7], *lie.exp6(dx[..., :6]))
        return torch.cat([p2, q2, x[..., 7:self.nq] + dx[..., 6:self.nv],
                          x[..., self.nq:] + dx[..., self.nv:]], dim=-1)

    def diff(self, x0, x1):
        """x1 (-) x0 in the tangent at x0."""
        ip, iq = lie.se3_inv(x0[..., :3], x0[..., 3:7])
        dp, dq = lie.se3_mul(ip, iq, x1[..., :3], x1[..., 3:7])
        return torch.cat([lie.log6(dp, dq),
                          x1[..., 7:self.nq] - x0[..., 7:self.nq],
                          x1[..., self.nq:] - x0[..., self.nq:]], dim=-1)

    def interpolate_config(self, q0, q1, alpha):
        """``pinocchio::interpolate``: SE(3) geodesic for the base, linear
        for the joints. ``alpha`` has the leading dims of q0."""
        p, quat = lie.se3_interpolate(q0[..., :3], q0[..., 3:7],
                                      q1[..., :3], q1[..., 3:7], alpha)
        qj = q0[..., 7:] + alpha.unsqueeze(-1) * (q1[..., 7:] - q0[..., 7:])
        return torch.cat([p, quat, qj], dim=-1)

    def normalize(self, x):
        """x with its quaternion block renormalized (drift control in long
        rollouts)."""
        return torch.cat([x[..., :3], lie.quat_normalize(x[..., 3:7]),
                          x[..., 7:]], dim=-1)
