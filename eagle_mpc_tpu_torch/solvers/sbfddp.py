"""Squash-box FDDP: smooth saturation + barrier homotopy.

PyTorch counterpart of ``eagle_mpc_tpu.solvers.sbfddp``. Each homotopy
stage anneals the squash smoothness and the barrier weights (parameters,
never structure) and runs an FDDP solve; a DDP polish then runs for the
elements that are still infeasible.

- ``solve``: the offline solve (the reference's SolverSbFDDP::solve), a
  Python loop over the rows of a :class:`HomotopySchedule`, each row a
  while-loop solve (``fddp.solve_fddp_or_ddp``).
- ``solve_fixed``: one batched fixed-depth solve for the MPC tick and its
  warm start, each stage ``fddp.solve_fixed``; the polish is skipped when
  every element is feasible (with ``sync_free`` it runs with a zero budget
  for the feasible elements instead, which changes nothing).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ocp import actuation as act
from ..ocp import problem as P
from . import fddp


@dataclasses.dataclass(frozen=True)
class SbFddpSettings:
    """Reference hyper-parameters."""

    smooth_init: float = 0.1
    smooth_mult: float = 0.5
    barrier_weight: float = 1e-3
    convergence_init: float = 1e-2
    convergence_stop: float = 1e-3
    convergence_mult: float = 0.1
    max_iters: int = 100          # per homotopy stage (solve's default)
    reg_init: float = 1e-9
    solver: fddp.SolverSettings = dataclasses.field(
        default_factory=fddp.SolverSettings)

    @property
    def n_stages(self) -> int:
        """Homotopy stages: while convergence >= convergence_stop."""
        n = 0
        c = self.convergence_init
        while c >= self.convergence_stop * (1 - 1e-12):
            n += 1
            c *= self.convergence_mult
        return max(n, 1)


class HomotopySchedule(NamedTuple):
    """Homotopy stages and DDP polish, one row per solver stage (tuples of
    equal length L):

    - FDDP stage: ddp False, th_stop and smooth annealed, maxiter > 0;
    - DDP polish: ddp True (runs only for still-infeasible elements);
    - a row with maxiter 0 is a no-op on the candidate."""

    smooth: tuple    # squash smoothness per stage
    th_stop: tuple   # stage convergence tolerance
    ddp: tuple       # plain-DDP stage (the polish)
    phase: tuple     # telemetry label (-2 = polish)
    maxiter: tuple   # per-stage iteration budget (int or (B,) tensor)

    @classmethod
    def from_settings(cls, settings: "SbFddpSettings",
                      maxiter) -> "HomotopySchedule":
        """The reference schedule: n_stages FDDP stages with annealed
        (smooth, th_stop), then the DDP polish at the final smoothness."""
        n = settings.n_stages
        smooth = tuple(settings.smooth_init * settings.smooth_mult ** k
                       for k in range(n))
        th = tuple(settings.convergence_init * settings.convergence_mult ** k
                   for k in range(n))
        return cls(smooth=smooth + smooth[-1:],
                   th_stop=th + (settings.convergence_stop,),
                   ddp=(False,) * n + (True,), phase=tuple(range(n)) + (-2,),
                   maxiter=(maxiter,) * (n + 1))


class SbFddpResult(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor           # pre-squash controls
    us_squash: torch.Tensor    # what the plant consumes
    cost: torch.Tensor
    iters: torch.Tensor
    feasible: torch.Tensor
    failed: torch.Tensor
    smooth: torch.Tensor
    trace: Optional[fddp.IterTrace] = None   # with settings.solver.record_trace:
                                             # the stages' traces concatenated


def barrier_slot_index(spec: P.ProblemSpec) -> int:
    for i, s in enumerate(spec.slots):
        if s.name == P.BARRIER_SLOT:
            return i
    raise ValueError("Problem has no barrier slot — build it with use_squash")


def _set_homotopy(spec, params: P.ProblemParams, smooth: float) -> P.ProblemParams:
    """Squash smoothness + barrier activation weights of batched params."""
    k = barrier_slot_index(spec)
    glob = params.glob
    w = act.barrier_quad_weights(glob.s_lb, glob.s_ub, smooth)
    act_w = tuple(w if i == k else a for i, a in enumerate(glob.act_w))
    return params._replace(glob=glob._replace(
        squash_smooth=torch.full_like(glob.squash_smooth, smooth),
        act_w=act_w))


def solve(spec: P.ProblemSpec, params: P.ProblemParams, xs_init=None,
          us_init=None, maxiter: Optional[int] = None, feasible: bool = False,
          settings: Optional[SbFddpSettings] = None,
          schedule: Optional[HomotopySchedule] = None) -> SbFddpResult:
    """The offline SbFDDP solve over a batch: ``params`` batched, candidates
    (B, T+1, nx) / (B, T, nu) (default: x0 tiled, zero controls). One
    while-loop solve per schedule row (default
    ``HomotopySchedule.from_settings(settings, maxiter)``, maxiter by
    default ``settings.max_iters`` per stage). The FDDP rows
    start infeasible; a polish row starts from the feasibility so far (the
    caller's ``feasible`` before any FDDP row) and runs with a zero budget
    for the elements already feasible."""
    settings = settings or SbFddpSettings()
    maxiter = settings.max_iters if maxiter is None else maxiter
    if xs_init is None or us_init is None:
        xs0, us0 = fddp.default_init(spec, params)
        xs_init = xs0 if xs_init is None else xs_init
        us_init = us0 if us_init is None else us_init
    if schedule is None:
        schedule = HomotopySchedule.from_settings(settings, maxiter)
    trace_len = int(maxiter) if settings.solver.record_trace else None
    B, device = xs_init.shape[0], xs_init.device
    xs, us = xs_init, us_init
    feas = torch.full((B,), bool(feasible), device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    failed = torch.zeros(B, dtype=torch.bool, device=device)
    traces = []
    for smooth, th_stop, ddp, phase, budget in zip(*schedule):
        budget = torch.as_tensor(budget, device=device).expand(B)
        res = fddp.solve_fddp_or_ddp(
            spec, settings.solver, _set_homotopy(spec, params, smooth), xs, us,
            torch.where(feas, 0, budget) if ddp else budget, th_stop,
            settings.reg_init, feas if ddp else False, ddp=ddp,
            trace_len=trace_len, phase_id=phase)
        xs, us = res.xs, res.us
        feas = feas | res.feasible if ddp else res.feasible
        iters = iters + res.iters
        failed = failed | res.failed
        traces.append(res.trace)
    final = _set_homotopy(spec, params, schedule.smooth[-1])
    return SbFddpResult(
        xs=xs, us=us, us_squash=P.squashed_controls(spec, final, us),
        cost=res.cost, iters=iters, feasible=feas, failed=failed,
        smooth=torch.full((B,), schedule.smooth[-1], dtype=xs.dtype,
                          device=device),
        trace=fddp.concat_traces(traces) if trace_len else None)


def solve_fixed(spec: P.ProblemSpec, params: P.ProblemParams, xs, us,
                depth: int = 2, feasible: bool = False,
                settings: Optional[SbFddpSettings] = None,
                n_alphas: Optional[int] = None, polish: str = "while",
                polish_maxiter: Optional[int] = None,
                sync_free: bool = False) -> SbFddpResult:
    """Fixed-depth SbFDDP over a batch: ``params`` batched, ``xs``
    (B, T+1, nx), ``us`` (B, T, nu).

    ``polish`` runs the DDP polish of the still-infeasible elements as
    ``while`` (the while-loop DDP solve, ``fddp.solve_fddp_or_ddp``; the
    default, as in the JAX package), ``while_fixed`` (early-exit loop over
    the fixed iteration; the bench's tick), ``fixed`` (``depth`` masked
    iterations with the full alpha ladder; the warm start) or ``none``.
    ``polish_maxiter`` caps its budget below ``depth``. The fixed-depth
    path refuses ``settings.solver.parallel_riccati`` (``ValueError``).

    ``sync_free`` (polish ``while``, ``fixed`` or ``none``) reads nothing
    on the host: every loop runs its static bound under the same masks
    (the stages all ``depth`` iterations, the polish always, at most
    ``depth`` iterations; K3's escalation runs inside its launch on both
    routes), with a result equal to the eager route's bit for bit. A CUDA
    graph can capture it."""
    if polish not in ("while", "while_fixed", "fixed", "none"):
        raise ValueError(
            f"polish must be while|while_fixed|fixed|none, got {polish!r}")
    if sync_free and polish == "while_fixed":
        raise ValueError("the while_fixed polish has no sync-free route")
    settings = settings or SbFddpSettings()
    fddp._check_fixed_settings(settings.solver)
    B, device = xs.shape[0], xs.device
    n = settings.n_stages
    smooths = [settings.smooth_init * settings.smooth_mult ** k
               for k in range(n)]
    th_stops = [settings.convergence_init * settings.convergence_mult ** k
                for k in range(n)]

    feas = torch.full((B,), bool(feasible), device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    failed = torch.zeros(B, dtype=torch.bool, device=device)
    for k in range(n):
        # the caller's feasibility claim seeds the first stage only
        res = fddp.solve_fixed(
            spec, settings.solver, _set_homotopy(spec, params, smooths[k]),
            xs, us, depth, th_stops[k], settings.reg_init,
            feas if k == 0 else None, ddp=False, n_alphas=n_alphas,
            final_cost_fallback=False, sync_free=sync_free)
        xs, us, feas = res.xs, res.us, res.feasible
        iters = iters + res.iters
        failed = failed | res.failed
    cost = res.cost

    params_f = _set_homotopy(spec, params, smooths[-1])
    budget = depth if polish_maxiter is None else min(polish_maxiter, depth)
    if polish != "none" and (sync_free or not bool(feas.all())):
        maxiter_p = torch.where(feas, 0, budget)
        th = settings.convergence_stop
        if polish == "while":
            res_p = fddp.solve_fddp_or_ddp(
                spec, settings.solver, params_f, xs, us, maxiter_p, th,
                settings.reg_init, False, ddp=True, final_cost_fallback=False,
                sync_free=budget if sync_free else None)
        elif polish == "while_fixed":
            res_p = fddp.solve_while_fixed_body(
                spec, settings.solver, params_f, xs, us, maxiter_p, th,
                settings.reg_init, ddp=True, n_alphas=n_alphas)
        else:
            res_p = fddp.solve_fixed(
                spec, settings.solver, params_f, xs, us, depth, th,
                settings.reg_init, ddp=True, maxiter=maxiter_p,
                final_cost_fallback=False, sync_free=sync_free)
        keep = feas
        xs = torch.where(keep[:, None, None], xs, res_p.xs)
        us = torch.where(keep[:, None, None], us, res_p.us)
        cost = torch.where(keep, cost, res_p.cost)
        feas = feas | res_p.feasible
        iters = iters + res_p.iters
        failed = failed | (~keep & res_p.failed)

    return SbFddpResult(
        xs=xs, us=us, us_squash=P.squashed_controls(spec, params_f, us),
        cost=cost, iters=iters, feasible=feas, failed=failed,
        smooth=torch.full((B,), smooths[-1], dtype=xs.dtype, device=device))
