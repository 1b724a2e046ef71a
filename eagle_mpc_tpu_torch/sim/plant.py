"""Aerial plant simulator (counterpart of ``eagle_mpc_tpu.sim.plant``): RK4
integration of the multibody dynamics, driven by squashed controls, for a
batch of scenarios; ``rollout`` steps it over a control sequence."""

from __future__ import annotations

import dataclasses

import torch

from ..config import specs as cspecs
from ..dynamics import rbd
from ..dynamics.model import RobotModel
from ..dynamics.state import State
from ..ocp import actuation as act
from ..utils import spans


@dataclasses.dataclass(frozen=True)
class AerialSimulator:
    model: RobotModel
    tau_f: torch.Tensor           # (6, n_rotors) on the simulator's device
    dt: float                     # seconds

    @classmethod
    def from_platform(cls, model: RobotModel, platform: cspecs.PlatformParams,
                      dt_ms: float, *, device, dtype) -> "AerialSimulator":
        return cls(model=model,
                   tau_f=torch.as_tensor(platform.tau_f, dtype=dtype,
                                         device=device),
                   dt=dt_ms / 1000.0)

    @property
    def state(self) -> State:
        return State(self.model.nq, self.model.nv)

    def _accel(self, x, u):
        nq = self.model.nq
        return rbd.fwd_dynamics(self.model, x[..., :nq], x[..., nq:],
                                act.actuation_tau(self.tau_f, u))

    @spans.spanned("sim.step")
    def step(self, x, u):
        """One RK4 step on the state manifold; x (..., nx), u (..., nu)."""
        st = self.state
        dt = self.dt

        def k(xi):
            return torch.cat([xi[..., st.nq:], self._accel(xi, u)], dim=-1)

        k0 = k(x)
        k1 = k(st.integrate(x, k0 * (dt / 2)))
        k2 = k(st.integrate(x, k1 * (dt / 2)))
        k3 = k(st.integrate(x, k2 * dt))
        return st.integrate(x, (k0 + 2 * k1 + 2 * k2 + k3) * (dt / 6))

    def rollout(self, x0, us):
        """``step`` over a control sequence: x0 (..., nx), us (..., N, nu)
        -> states (..., N+1, nx)."""
        xs = [x0]
        for n in range(us.shape[-2]):
            xs.append(self.step(xs[-1], us[..., n, :]))
        return torch.stack(xs, dim=-2)
