"""MPC controller base: problem scaffolding and reference sampling.

PyTorch counterpart of ``eagle_mpc_tpu.mpc.base``. A controller owns a
static ``ProblemSpec`` (``knots - 1`` running nodes + terminal), base
parameters ``params0`` (unbatched tensors on the controller's device) and
an ``update_problem(t_ms, params)`` that re-aims per-node references and
activity for a batch of scenarios.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import specs as cspecs
from ..ocp import actuation as act
from ..ocp import costs as C
from ..ocp import problem as P
from ..solvers import fddp, sbfddp

_INTEGRATOR_MAP = {
    cspecs.INTEGRATOR_EULER: P.EULER,
    cspecs.INTEGRATOR_RK4: P.RK4,
}


def _try_param(getter, key, default):
    """``getter(key)``, or ``default`` where the YAML leaves the key out."""
    try:
        return getter(key)
    except cspecs.MissingValueException:
        return default


@dataclasses.dataclass
class MpcAbstract:
    """Shared construction + solve plumbing; subclasses fill ``spec`` and
    ``params0`` and implement ``update_problem``."""

    mpc_params: cspecs.MpcParamsSpec
    device: torch.device = dataclasses.field(kw_only=True)
    dtype: torch.dtype = dataclasses.field(kw_only=True)
    spec: P.ProblemSpec = dataclasses.field(init=False)
    params0: P.ProblemParams = dataclasses.field(init=False)

    @property
    def dt(self) -> int:
        """Node duration in ms."""
        return self.mpc_params.dt

    @property
    def knots(self) -> int:
        return self.mpc_params.knots

    @property
    def iters(self) -> int:
        """Per-tick solver iteration budget."""
        return self.mpc_params.iters

    @property
    def solver_type(self) -> str:
        return self.mpc_params.solver

    @property
    def use_squash(self) -> bool:
        return self.mpc_params.solver == cspecs.SOLVER_SBFDDP

    @property
    def state(self):
        return self.spec.state

    def update_problem(self, t_ms, params: P.ProblemParams) -> P.ProblemParams:
        raise NotImplementedError

    def solver_settings(self, convergence_init: float = 1e-3) -> sbfddp.SbFddpSettings:
        """MPC-loop settings: one homotopy stage at convergence_init=1e-3."""
        return sbfddp.SbFddpSettings(convergence_init=convergence_init)

    def solve(self, params: P.ProblemParams, xs, us, maxiter: Optional[int] = None,
              settings: Optional[sbfddp.SbFddpSettings] = None,
              schedule: Optional[sbfddp.HomotopySchedule] = None,
              fixed: bool = False, n_alphas: Optional[int] = None,
              sync_free: bool = False):
        """One warm-started batched MPC solve (``maxiter`` by default the
        controller's ``iters``):

        - SbFDDP: the while-loop ``sbfddp.solve`` (``schedule`` overrides
          its homotopy rows), or with ``fixed=True`` the fixed-depth
          ``sbfddp.solve_fixed`` at depth ``maxiter`` with its default
          polish (``n_alphas`` truncates its line-search ladder; a
          ``schedule`` is refused; ``sync_free`` takes its route that reads
          nothing on the host, for a CUDA graph, with the same result);
        - a box mission: Box-FDDP/Box-DDP, the while loop on raw controls
          (the spec has no squash)."""
        maxiter = int(self.iters if maxiter is None else maxiter)
        if sync_free and not (fixed
                              and self.solver_type == cspecs.SOLVER_SBFDDP):
            raise ValueError("sync_free is a route of the fixed-depth SbFDDP "
                             "solve (fixed=True) only")
        if self.solver_type == cspecs.SOLVER_SBFDDP:
            settings = settings or self.solver_settings()
            if fixed:
                if schedule is not None:
                    raise ValueError("fixed=True uses a static stage layout; "
                                     "schedule rows are a while-solver feature")
                return sbfddp.solve_fixed(self.spec, params, xs, us,
                                          depth=maxiter, settings=settings,
                                          n_alphas=n_alphas,
                                          sync_free=sync_free)
            return sbfddp.solve(self.spec, params, xs, us, maxiter=maxiter,
                                settings=settings, schedule=schedule)
        box = (fddp.solve_box_fddp
               if self.solver_type == cspecs.SOLVER_BOX_FDDP
               else fddp.solve_box_ddp)
        res = box(self.spec, fddp.SolverSettings(), params, xs, us, maxiter,
                  1e-9)
        return sbfddp.SbFddpResult(
            xs=res.xs, us=res.us, us_squash=res.us, cost=res.cost,
            iters=res.iters, feasible=res.feasible, failed=res.failed,
            smooth=torch.zeros_like(res.cost))

    def _finalize_problem(self, slots, slot_weights, slot_active, slot_refs,
                          act_w, lbs, ubs, x0=None, squash_smooth=0.1):
        """Assemble spec + params0 from per-slot scaffolding; appends the
        SbFDDP barrier slot (running nodes only) when squashing."""
        mp = self.mpc_params
        model = mp.model
        nu = mp.platform.nu
        T = self.knots - 1
        s_lb = np.asarray(mp.platform.u_lb, dtype=np.float64)
        s_ub = np.asarray(mp.platform.u_ub, dtype=np.float64)

        slots = list(slots)
        act_w, lbs, ubs = list(act_w), list(lbs), list(ubs)
        slot_weights, slot_active = list(slot_weights), list(slot_active)
        slot_refs = list(slot_refs)
        if self.use_squash:
            slots.append(C.CostSlot(name=P.BARRIER_SLOT, kind=C.CONTROL,
                                    activation=C.WQBARRIER, nr=nu, ref_dim=nu))
            act_w.append(act.barrier_quad_weights(s_lb, s_ub, squash_smooth))
            lbs.append(s_lb.copy())
            ubs.append(s_ub.copy())
            slot_weights.append(sbfddp.SbFddpSettings.barrier_weight)
            slot_active.append(1.0)
            slot_refs.append(np.zeros(nu))

        K = len(slots)
        weight = np.tile(np.asarray(slot_weights, dtype=np.float64), (T + 1, 1))
        active = np.tile(np.asarray(slot_active, dtype=np.float64), (T + 1, 1))
        refs = [np.tile(np.asarray(r, dtype=np.float64), (T + 1, 1))
                for r in slot_refs]
        if self.use_squash:
            active[T, K - 1] = 0.0   # the barrier acts on running nodes only

        self.spec = P.ProblemSpec(
            model=model, nu=nu, tau_f=tuple(map(tuple, mp.platform.tau_f)),
            slots=tuple(slots), integrator=_INTEGRATOR_MAP[mp.integration_method],
            T=T, dt=mp.dt / 1000.0, use_squash=self.use_squash)
        P.check_scope(self.spec)
        if x0 is None:
            x0 = np.zeros(model.nx)
            x0[6] = 1.0
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                      dtype=self.dtype, device=self.device)
        self.params0 = P.ProblemParams(
            x0=t(x0),
            node=P.NodeParams(weight=t(weight), active=t(active),
                              refs=tuple(t(r) for r in refs)),
            glob=P.GlobalParams(
                act_w=tuple(t(a) for a in act_w), lb=tuple(t(a) for a in lbs),
                ub=tuple(t(a) for a in ubs), squash_smooth=t(squash_smooth),
                s_lb=t(s_lb), s_ub=t(s_ub)))


def make_reference_sampler(state, state_ref: np.ndarray, t_ref: np.ndarray,
                           device, dtype, hold_yaw_only: bool = False) -> Callable:
    """Sampler of the offline reference trajectory at times t_ms (any
    shape) -> (..., nx). Configurations follow the free-flyer geodesic and
    velocities are linear; past the last sample the final configuration is
    held at zero velocity, with only the yaw of its attitude under
    ``hold_yaw_only`` (RailMpc's hold)."""
    ref = torch.as_tensor(np.asarray(state_ref), dtype=dtype, device=device)
    t_ref_t = torch.as_tensor(np.asarray(t_ref), dtype=dtype, device=device)
    N, nq = ref.shape[0], state.nq
    q_hold = np.array(state_ref[-1, :nq], dtype=np.float64)
    if hold_yaw_only:
        # quaternion (x, y, z, w): keep (z, w)
        quat = np.array([0.0, 0.0, q_hold[5], q_hold[6]])
        q_hold[3:7] = quat / np.linalg.norm(quat)
    x_hold = torch.as_tensor(np.concatenate([q_hold, np.zeros(state.nv)]),
                             dtype=dtype, device=device)

    def sample(t_ms):
        idx = torch.searchsorted(t_ref_t, t_ms.contiguous(), right=True)
        hold = idx >= N
        i1 = torch.clamp(idx, 1, N - 1)
        i0 = i1 - 1
        t0, t1 = t_ref_t[i0], t_ref_t[i1]
        alpha = (t_ms - t0) / (t1 - t0)
        x0, x1 = ref[i0], ref[i1]
        q = state.interpolate_config(x0[..., :nq], x1[..., :nq], alpha)
        v = x0[..., nq:] + alpha.unsqueeze(-1) * (x1[..., nq:] - x0[..., nq:])
        return torch.where(hold.unsqueeze(-1), x_hold, torch.cat([q, v], dim=-1))

    return sample


def stage_index(t_stages, t):
    """upper_bound(t_stages, t) - 1 over a small boundary table: the index
    of the stage that has begun by time t (-1 before the first)."""
    return (t[..., None] >= t_stages).sum(dim=-1) - 1


def stage_boundaries(stages, dt_ms: int) -> np.ndarray:
    """Cumulative stage end-times with every duration clamped to >= dt;
    length n_stages + 1, first entry 0."""
    t = [0]
    for st in stages:
        t.append(t[-1] + max(st.duration, dt_ms))
    return np.asarray(t, dtype=np.int64)
