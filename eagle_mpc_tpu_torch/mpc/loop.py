"""Closed-loop MPC: the reference demo loop over a batch of scenarios.

PyTorch counterpart of ``eagle_mpc_tpu.mpc.loop``. Each tick of the plant
(``dt_sim_ms``) sets x0 from the plant state, re-aims the problem at the
tick's time (``update_problem``), re-solves it from the previous solution
(``controller.solve``) and applies the first squashed control to the RK4
plant. The loop is a Python loop over ticks; the per-tick records stay on
the device and are copied to the host once, after the last tick.
``offline_solution`` and ``hold_padded`` are the demos' offline solve and
warm start.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ocp import problem as P
from ..sim.plant import AerialSimulator
from ..solvers import sbfddp
from ..utils import spans
from . import base


class ClosedLoopResult(NamedTuple):
    states: torch.Tensor       # (B, n_steps + 1, nx) plant trajectory (host)
    controls: torch.Tensor     # (B, n_steps, nu) applied squashed controls (host)
    solve_iters: torch.Tensor  # (B, n_steps) (host)
    costs: torch.Tensor        # (B, n_steps) (host)
    xs: torch.Tensor           # (B, T+1, nx) last solver candidate (device)
    us: torch.Tensor           # (B, T, nu) (device)


def run_closed_loop(controller: base.MpcAbstract, simulator: AerialSimulator,
                    x0, xs_warm, us_warm, n_steps: int, dt_sim_ms: float,
                    maxiter: Optional[int] = None,
                    settings: Optional[sbfddp.SbFddpSettings] = None,
                    fixed: bool = False) -> ClosedLoopResult:
    """``n_steps`` closed-loop ticks of B scenarios from the plant states x0
    (B, nx) and the initial solver candidate ``xs_warm`` (B, T+1, nx) /
    ``us_warm`` (B, T, nu) (the offline solution's first T+1 states and T
    controls in the reference demo). Tick i runs at t = i * dt_sim_ms;
    ``fixed`` routes the solve as ``MpcAbstract.solve`` does (the
    while-loop SbFDDP by default, the fixed-depth path with True)."""
    settings = settings or controller.solver_settings()
    B, dtype, device = xs_warm.shape[0], xs_warm.dtype, xs_warm.device
    params0 = P.expand_params(controller.params0, B)
    x = torch.as_tensor(x0, dtype=dtype, device=device)
    xs, us = xs_warm, us_warm
    states, controls, iters, costs = [x], [], [], []
    for i in range(n_steps):
        spans.tick()
        t_ms = torch.full((B,), i * dt_sim_ms, dtype=dtype, device=device)
        with spans.span("mpc.update"):
            params = controller.update_problem(t_ms, params0._replace(x0=x))
        res = controller.solve(params, xs, us, maxiter=maxiter,
                               settings=settings, fixed=fixed)
        u = res.us_squash[:, 0]
        x = simulator.step(x, u)
        xs, us = res.xs, res.us
        states.append(x)
        controls.append(u)
        iters.append(res.iters)
        costs.append(res.cost)
    host = lambda seq: torch.stack(seq, dim=1).cpu()
    return ClosedLoopResult(states=host(states), controls=host(controls),
                            solve_iters=host(iters), costs=host(costs),
                            xs=xs, us=us)


def offline_solution(traj, dt_ms: int, maxiter: int, device, dtype):
    """The mission's offline SbFDDP solve at B=1 (squashed controls, Euler
    nodes of ``dt_ms``): (its states, its controls) as float64 numpy
    arrays, and the solve's result."""
    spec, params = P.from_trajectory(traj, dt_ms=dt_ms, use_squash=True,
                                     integrator="IntegratedActionModelEuler",
                                     dtype=dtype, device=device)
    res = sbfddp.solve(spec, P.expand_params(params, 1), maxiter=maxiter)
    host = lambda a: a[0].detach().to("cpu", torch.float64).numpy()
    return host(res.xs), host(res.us), res


def hold_padded(T: int, xs_off, us_off, device, dtype):
    """The demos' warm start (1, T+1, nx), (1, T, nu): an offline
    solution's first T+1 states and T controls, its last ones repeated
    where it is shorter."""
    pad = max(0, T + 1 - len(xs_off))
    hold = lambda a, n: np.vstack([a, np.tile(a[-1], (pad, 1))])[None, :n]
    to_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return to_dev(hold(xs_off, T + 1)), to_dev(hold(us_off, T))
