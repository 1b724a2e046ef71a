"""FDDP/DDP solvers over an explicit batch of problems.

PyTorch counterpart of ``eagle_mpc_tpu.solvers.fddp``: every tensor
carries a leading scenario axis B and JAX's per-element control flow
becomes per-element masks, each element frozen once it stops.

- Direction: node linearization (kernel K1), gaps, Riccati backward pass
  (kernel K3, which also runs the while-loop solver's regularization
  escalation per problem in the same launch; the Box-DDP pass with its box
  QP stays plain, as in the reference package; with ``parallel_riccati``
  the while-loop solver's non-box pass is the log-depth scan of
  ``solvers.priccati``; these two escalate in rounds on the host).
- Line search: the whole alpha ladder rolled out at once (kernel K2) and
  the first accepted alpha per element, which is the reference's
  sequential early-exit choice since alphas descend.
- Two solve loops share them. ``solve_fddp_or_ddp`` is the while-loop solver
  of the offline path: a failed backward pass re-runs at escalated
  regularization inside the iteration. ``solve_fixed`` and
  ``solve_while_fixed_body`` are the MPC tick's fixed iteration: a failed
  pass escalates the regularization and consumes the iteration.
- Matrix products run in full float32 (TF32 off): reduced precision breaks
  the PD margin of Quu.
- ``sync_free=True`` (the fixed tick's route, ``solve_fixed`` and the
  ``while`` polish through ``solve_fddp_or_ddp``) replaces every host test
  of a loop by its static bound: the loops run their whole budget under
  the same masks, so the result is the eager route's bit for bit and no
  tensor is read on the host (what a CUDA graph capture needs). K3's
  escalation reads nothing on the host on either route.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ocp import problem as P
from ..ops import riccati_cuda, rollout_cuda, smallmat
from ..utils import spans


def full_precision_matmul() -> None:
    """Full-f32 matrix products on the card (set on solver entry)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration (Crocoddyl defaults)."""

    n_alphas: int = 10            # alphas = 2^-k, k = 0..n_alphas-1
    th_acceptstep: float = 0.1
    th_acceptnegstep: float = 2.0
    th_grad: float = 1e-12
    th_stepdec: float = 0.5
    th_stepinc: float = 0.01
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_factor: float = 10.0
    th_stop_gaps: float = 1.0
    boxqp_iters: int = 12         # projected-Newton iterations (box solvers)
    parallel_riccati: bool = False  # log-depth scan backward pass on the
                                    # while-loop path (solvers/priccati.py)
    record_trace: bool = False    # return per-iteration IterTrace telemetry
    # deviation switches: the reference's (Crocoddyl's) semantics, selectable
    # so tests can pin the failure modes the defaults prevent
    crocoddyl_signed_d0: bool = False       # d0 < th_grad vs |d0| < th_grad
    crocoddyl_negstep_always: bool = False  # negative-step acceptance also for
                                            # feasible candidates
    crocoddyl_signed_stop: bool = False     # stop on stop_val < th_stop even
                                            # when negative
    th_diverge: float = 1e8       # forward-pass divergence bound on cost and
                                  # |x|_inf (see the reference package)

    @property
    def alphas(self):
        return tuple(0.5 ** k for k in range(self.n_alphas))


class BackwardPassData(NamedTuple):
    k: torch.Tensor      # (B, T, nu)
    K: torch.Tensor      # (B, T, nu, ndx)
    Qu: torch.Tensor     # (B, T, nu)
    Quuk: torch.Tensor   # (B, T, nu)
    Vx: torch.Tensor     # (B, T+1, ndx)
    Vxx: torch.Tensor    # (B, T+1, ndx, ndx)
    ok: torch.Tensor     # (B,) all finite


class IterTrace(NamedTuple):
    """Per-iteration solver telemetry (the reference's CallbackVerbose),
    (B, L) per field; rows past an element's iterations hold NaN (-1 for
    the int8 fields)."""

    cost: torch.Tensor        # cost after each iteration
    stop: torch.Tensor        # cost reduction of the accepted step
    steplength: torch.Tensor  # accepted alpha (the last alpha if none)
    xreg: torch.Tensor        # state regularization after the schedule
    gap_norm: torch.Tensor    # max |gap| of the candidate
    accepted: torch.Tensor    # int8: 1 accepted, 0 rejected, -1 unused
    phase: torch.Tensor       # int8: homotopy stage; -2 = DDP polish


def _empty_trace(B: int, n: int, dtype, device) -> IterTrace:
    nan = torch.full((B, n), float("nan"), dtype=dtype, device=device)
    minus1 = torch.full((B, n), -1, dtype=torch.int8, device=device)
    return IterTrace(cost=nan, stop=nan.clone(), steplength=nan.clone(),
                     xreg=nan.clone(), gap_norm=nan.clone(), accepted=minus1,
                     phase=minus1.clone())


def concat_traces(traces) -> IterTrace:
    """Concatenate per-stage traces (homotopy stages + DDP polish) along
    the iteration axis."""
    return IterTrace(*(torch.cat(parts, dim=-1) for parts in zip(*traces)))


def format_trace(trace: IterTrace, header: bool = True) -> str:
    """CallbackVerbose-style table of one element's recorded solve (index
    the batch first: ``IterTrace(*(a[i] for a in trace))``); unused rows
    are skipped."""
    cost, stop, step, xreg, gap, acc, phase = (
        a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in trace)
    lines = []
    if header:
        lines.append(f"{'iter':>4} {'phase':>6} {'cost':>14} {'stop':>12} "
                     f"{'step':>8} {'xreg':>10} {'gap_norm':>10} {'acc':>4}")
    it = 0
    for i in range(cost.shape[0]):
        if acc[i] == -1:
            continue
        it += 1
        ph = "ddp" if phase[i] == -2 else str(int(phase[i]))
        lines.append(f"{it:>4} {ph:>6} {cost[i]:>14.6e} {stop[i]:>12.4e} "
                     f"{step[i]:>8.4f} {xreg[i]:>10.2e} {gap[i]:>10.3e} "
                     f"{int(acc[i]):>4}")
    return "\n".join(lines)


class SolveResult(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    cost: torch.Tensor
    iters: torch.Tensor
    feasible: torch.Tensor
    stop: torch.Tensor
    gap_norm: torch.Tensor
    xreg: torch.Tensor
    failed: torch.Tensor
    trace: Optional[IterTrace] = None   # with settings.record_trace


class _Carry(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    cost: torch.Tensor
    feasible: torch.Tensor
    xreg: torch.Tensor
    ureg: torch.Tensor
    it: torch.Tensor
    stop_val: torch.Tensor
    gap_norm: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    trace: Optional[IterTrace] = None   # the while-loop solver's, if recorded


def _bcast(mask, a):
    return mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))


def _select(mask, a, b):
    """Per-element where over (nested) NamedTuples of (B, ...) tensors;
    None leaves stay None."""
    def sel(x, y):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return torch.where(_bcast(mask, x), x, y)
        return _select(mask, x, y)
    return type(a)(*(sel(x, y) for x, y in zip(a, b)))


def _all_finite(a):
    return torch.isfinite(a).flatten(1).all(dim=1)


# ---------------------------------------------------------------------------
# Direction: gaps and the Riccati recursion
# ---------------------------------------------------------------------------

@spans.spanned("solver.gaps")
def _gaps(spec, params, xs, xnext, feasible):
    """fs[0] = x0 (-) xs0; fs[t+1] = f(x_t, u_t) (-) xs_{t+1}; zero where the
    candidate is feasible. Returns (B, T+1, ndx)."""
    st = spec.state
    fs = torch.cat([st.diff(xs[:, :1], params.x0[:, None]),
                    st.diff(xs[:, 1:], xnext)], dim=1)
    return torch.where(feasible[:, None, None], torch.zeros_like(fs), fs)


def _boxqp(H, q, lo, hi, x0, n_iters: int):
    """Projected-Newton box QP: min 0.5 x'Hx + q'x s.t. lo <= x <= hi, over
    a batch: H (B, n, n), q, lo, hi, x0 (B, n).

    Fixed-iteration, mask-based variant of the Tassa/Crocoddyl BoxQP: the
    clamped set masks rows and columns of H (the identity on the clamped
    ones), and each iteration takes the best of the clipped Newton step at
    8 step lengths and the current point (monotone by construction).
    Infinite bounds give the unconstrained Newton step. Returns (x, free
    mask)."""
    eps = 1e-9
    ladder = 0.5 ** torch.arange(8, dtype=H.dtype, device=H.device)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    lo_eps, hi_eps = lo + eps, hi - eps
    lo_c, hi_c = lo[:, None], hi[:, None]
    rows = torch.arange(H.shape[0], device=H.device)

    def free_set(x):
        g = q + (H @ x[..., None])[..., 0]
        return g, ~(((x <= lo_eps) & (g > 0)) | ((x >= hi_eps) & (g < 0)))

    x = torch.minimum(torch.maximum(x0, lo), hi)
    for _ in range(n_iters):
        g, free = free_set(x)
        M = torch.where(free[:, :, None] & free[:, None, :], H, eye)
        dx = smallmat.solve_psd(M, torch.where(free, -g, 0.0))
        cands = torch.minimum(torch.maximum(
            x[:, None] + ladder[None, :, None] * dx[:, None], lo_c), hi_c)
        cands = torch.cat([cands, x[:, None]], dim=1)        # (B, 9, n)
        fval = (0.5 * ((cands @ H) * cands).sum(-1)
                + (cands @ q[..., None])[..., 0])
        x = cands[rows, fval.argmin(dim=1)]
    return x, free_set(x)[1]


def _box_gains(us, s_lb, s_ub, n_iters: int):
    """Gains of the Box-DDP backward pass (Crocoddyl's SolverBoxDDP): the
    feedforward from the box QP on the control bounds around us, the
    feedback rows of the clamped controls zeroed. A ``gains`` hook of
    ``riccati_cuda.backward_plain``."""
    def gains(t, Quu, Qu, Qxu):
        u_t = us[:, t]
        du, free = _boxqp(Quu, Qu, s_lb - u_t, s_ub - u_t,
                          torch.zeros_like(u_t), n_iters)
        eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype, device=Quu.device)
        M = torch.where(free[:, :, None] & free[:, None, :], Quu, eye)
        return -du, smallmat.solve_psd_mat(
            M, torch.where(free[:, :, None], Qxu.mT, 0.0))
    return gains


@spans.spanned("solver.backward")
def _backward_pass(spec, derivs, term, fs, xreg, ureg, feasible, box=None):
    """Regularized Riccati recursion over the batch: kernel K3, or with
    ``box = (us, s_lb, s_ub, qp_iters)`` the plain Box-DDP recursion."""
    _, LxT, LxxT = term
    VxT, VxxT = riccati_cuda.terminal_value(LxT, LxxT, fs[:, -1], xreg,
                                            feasible)
    args = (derivs.Fx, derivs.Fu, derivs.Lx, derivs.Lu, derivs.Lxx,
            derivs.Lxu, derivs.Luu, fs[:, :-1], VxT, VxxT, xreg, ureg,
            feasible)
    if box is None:
        k, K, Qu, Quuk, Vx_r, Vxx_r = riccati_cuda.backward(*args)
    else:
        k, K, Qu, Quuk, Vx_r, Vxx_r = riccati_cuda.backward_plain(
            *args, gains=_box_gains(*box))
    Vx = torch.cat([Vx_r, VxT[:, None]], dim=1)
    Vxx = torch.cat([Vxx_r, VxxT[:, None]], dim=1)
    ok = _all_finite(k) & _all_finite(K) & _all_finite(Vx)
    return BackwardPassData(k, K, Qu, Quuk, Vx, Vxx, ok)


@spans.spanned("solver.backward")
def _escalated_backward_pass(settings, derivs, term, fs, xreg, ureg, feasible,
                             derivs_ok, n_retries: int, sync_free: bool):
    """K3 with the regularization escalation in the kernel, one launch:
    (pass data, xreg, ureg, passes each row ran (B,) int32)."""
    _, LxT, LxxT = term
    (k, K, Qu, Quuk, Vx_r, Vxx_r, VxT, VxxT, xreg, ureg, ok,
     passes) = riccati_cuda.backward_escalating(
        derivs.Fx, derivs.Fu, derivs.Lx, derivs.Lu, derivs.Lxx, derivs.Lxu,
        derivs.Luu, fs, LxT, LxxT, xreg, ureg, feasible, derivs_ok,
        settings.reg_factor, settings.reg_max, n_retries, sync_free)
    Vx = torch.cat([Vx_r, VxT[:, None]], dim=1)
    Vxx = torch.cat([Vxx_r, VxxT[:, None]], dim=1)
    return BackwardPassData(k, K, Qu, Quuk, Vx, Vxx, ok), xreg, ureg, passes


def _linearize(spec, params, xs, us, feasible):
    """K1 and the terminal node: (derivatives, terminal (cost, Lx, Lxx),
    cost, gaps, derivatives finite) per element."""
    derivs, term = P.calc_diff_all(spec, params, xs, us)
    cost = derivs.cost.sum(dim=1) + term[0]
    fs = _gaps(spec, params, xs, derivs.xnext, feasible)
    derivs_ok = (_all_finite(derivs.Fx) & _all_finite(derivs.Lxx)
                 & _all_finite(derivs.Lu) & torch.isfinite(cost)
                 & _all_finite(term[2]))
    return derivs, term, cost, fs, derivs_ok


def _box_info(settings, params, us, box: bool):
    return ((us, params.glob.s_lb, params.glob.s_ub, settings.boxqp_iters)
            if box else None)


@functools.lru_cache(maxsize=32)
def escalation_bound(settings: SolverSettings, reg_start: float, dtype) -> int:
    """The most retries the escalation can take from a regularization of at
    least ``reg_start``: multiplications by reg_factor, clamped at reg_max,
    until reg_max is reached, counted in ``dtype``'s arithmetic (18 with the
    defaults in float64, 19 in float32), or until the product no longer
    grows (a reg_factor of at most 1 or a regularization of 0: a further
    round would rerun the same pass). K3 retries at most this many times;
    the host's rounds on the sync-free route run this many."""
    real = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    x, f, hi = real(reg_start), real(settings.reg_factor), real(settings.reg_max)
    n = 0
    while x < hi:
        nx = min(real(x * f), hi)
        if not nx > x:
            break
        x = nx
        n += 1
    return n


def _compute_direction(spec, settings, params, xs, us, feasible, xreg, ureg,
                       box: bool = False, sync_free: bool = False,
                       n_retries: Optional[int] = None, *, active=None):
    """Linearization and backward pass with the regularization escalation
    of the reference (a do-while): the first pass runs at the incoming
    regularization; then, while an element's pass failed with finite
    derivatives below reg_max, its regularization grows by reg_factor and
    the pass runs again, at most ``n_retries`` times (``escalation_bound``;
    by default from the smallest incoming xreg, read on the host).
    Non-finite derivatives fail fast (no escalation). K3 runs the whole
    escalation in one launch, on both routes. The Box-DDP pass and, with
    ``settings.parallel_riccati``, ``priccati.parallel_backward_pass`` have
    no kernel and escalate in rounds on the host (:func:`_host_escalation`).
    ``active``: the elements whose result the caller keeps (the passes they
    needed are counted, see ``utils.spans``; default every element).
    Returns (cost, fs, bp, xreg, ureg, failed)."""
    if active is None and spans.on():
        active = torch.ones_like(feasible)
    if n_retries is None:
        n_retries = escalation_bound(
            settings, min(settings.reg_min, float(xreg.min())), xreg.dtype)
    derivs, term, cost, fs, derivs_ok = _linearize(spec, params, xs, us,
                                                   feasible)
    info = _box_info(settings, params, us, box)
    with spans.span("solver.escalation"):
        if info is None and not settings.parallel_riccati:
            bp, xreg, ureg, passes = _escalated_backward_pass(
                settings, derivs, term, fs, xreg, ureg, feasible, derivs_ok,
                n_retries, sync_free)
            if spans.on():
                spans.count(spans.PASSES, active, values=passes)
                spans.add(spans.RETRIES, active, values=passes - 1)
        else:
            bp, xreg, ureg = _host_escalation(
                spec, settings, derivs, term, fs, xreg, ureg, feasible,
                derivs_ok, info, sync_free, n_retries, active)
    return cost, fs, bp, xreg, ureg, ~bp.ok


def _host_escalation(spec, settings, derivs, term, fs, xreg, ureg, feasible,
                     derivs_ok, box_info, sync_free: bool, n_retries: int,
                     active):
    """The escalation in rounds over the batch, for the passes without a
    kernel (the Box-DDP pass; ``priccati.parallel_backward_pass`` with
    ``settings.parallel_riccati``): after the first pass, each round reruns
    the pass at the grown regularization of the elements that retry, and
    those keep the new result. With ``sync_free`` all ``n_retries`` rounds
    run, masked, instead of testing on the host whether any element
    retries. Returns (bp, xreg, ureg)."""
    if settings.parallel_riccati and box_info is None:
        from . import priccati

        def run_bp(xr, ur):
            return priccati.parallel_backward_pass(spec, derivs, term, fs, xr,
                                                   ur, feasible)
    else:
        def run_bp(xr, ur):
            return _backward_pass(spec, derivs, term, fs, xr, ur, feasible,
                                  box_info)
    bp = run_bp(xreg, ureg)
    spans.count(spans.PASSES, active)
    f, hi = settings.reg_factor, settings.reg_max
    rounds = 0
    while not sync_free or rounds < n_retries:
        retry = ~bp.ok & derivs_ok & (xreg < hi)
        if not sync_free and not bool(retry.any()):
            break
        xreg = torch.where(retry, torch.clamp(xreg * f, max=hi), xreg)
        ureg = torch.where(retry, torch.clamp(ureg * f, max=hi), ureg)
        bp = _select(retry, run_bp(xreg, ureg), bp)
        spans.count(spans.PASSES, retry, active)
        spans.add(spans.RETRIES, retry, active)
        rounds += 1
    return bp, xreg, ureg


# ---------------------------------------------------------------------------
# Line search: every alpha of the ladder at once (kernel K2)
# ---------------------------------------------------------------------------

def _forward_pass_multi(spec, settings, params, xs, us, bp, fs, alphas,
                        feasible, ddp: bool, box: bool = False):
    """FDDP line-search rollouts for every (scenario, alpha): gaps contract
    by (alpha - 1) where infeasible (plain DDP rollout when ``ddp``), the
    controls clipped to their bounds when ``box``.
    Returns xs_try (B, A, T+1, nx), us_try (B, A, T, nu), cost_try (B, A),
    diverged (B, A)."""
    st = spec.state
    T = spec.T
    keep = (~feasible[:, None]) & (alphas != 1.0)[None, :]
    if ddp:
        keep = torch.zeros_like(keep)
    xs_r, us_try, cs, xn = rollout_cuda.rollout(
        spec, params, xs, us, bp.k, bp.K, fs, alphas, keep, box=box)
    gap = fs[:, None, -1] * (alphas[None, :, None] - 1.0)
    xT = torch.where(keep[..., None], st.integrate(xn, gap), xn)
    node = params.node
    tview = P.node_views(node, (slice(None), None, T))
    cT = P.terminal_calc(spec, tview, P.glob_over_nodes(params.glob), xT)
    cost_try = cs.sum(dim=-1) + cT
    th = settings.th_diverge
    cum = torch.cumsum(cs, dim=-1)
    amax = lambda a: a.abs().amax(dim=(-2, -1))
    diverged = (~torch.isfinite(xs_r).all(dim=-1).all(dim=-1)
                | (amax(xs_r) >= th)
                | ~torch.isfinite(cum).all(dim=-1) | (cum.amax(dim=-1) >= th)
                | ~torch.isfinite(cost_try) | (cost_try >= th)
                | (xT.abs().amax(dim=-1) >= th))
    return torch.cat([xs_r, xT[:, :, None]], dim=2), us_try, cost_try, diverged


def _expected_improvement_terms(bp, fs, feasible):
    """(dg, dq) of Crocoddyl's SolverFDDP::updateExpectedImprovement."""
    dg = torch.sum(bp.Qu * bp.k, dim=(1, 2))
    dq = -torch.sum(bp.k * bp.Quuk, dim=(1, 2))
    gap_dg = -torch.sum(bp.Vx * fs, dim=(1, 2))
    gap_dq = torch.sum(fs * (bp.Vxx @ fs[..., None])[..., 0], dim=(1, 2))
    zero = torch.zeros_like(dg)
    return (dg + torch.where(feasible, zero, gap_dg),
            dq + torch.where(feasible, zero, gap_dq))


@spans.spanned("solver.expected_improvement")
def _expected_improvement(spec, bp, fs, xs, xs_try, dg, dq, feasible):
    """Per-candidate (d0, d1) (B, A); dv = -sum fs . Vxx . (xs_try (-) xs)
    when infeasible."""
    dxs = spec.state.diff(xs_try, xs[:, None])
    dv = -torch.sum(fs[:, None] * (bp.Vxx[:, None] @ dxs[..., None])[..., 0],
                    dim=(2, 3))
    dv = torch.where(feasible[:, None], torch.zeros_like(dv), dv)
    return dg[:, None] + dv, dq[:, None] - 2.0 * dv


def _accept(settings, ddp: bool, feasible, alphas, d0, d1, dV):
    """The reference's accept rule with the deviation switches, per
    candidate: feasible (B,), alphas (A,), d0, d1, dV broadcasting to
    (B, A)."""
    feas = feasible[:, None]
    al = alphas[None, :]
    dVexp = al * (d0 + 0.5 * al * d1)
    if settings.crocoddyl_signed_d0:
        at_stationary = d0 < settings.th_grad
    else:
        at_stationary = d0.abs() < settings.th_grad
    if ddp:
        return (dVexp >= 0) & (at_stationary | ~feas
                               | (dV > settings.th_acceptstep * dVexp))
    neg_ok = dV > settings.th_acceptnegstep * dVexp
    if not settings.crocoddyl_negstep_always:
        neg_ok = ~feas & neg_ok
    return torch.where(dVexp >= 0,
                       at_stationary | (dV > settings.th_acceptstep * dVexp),
                       neg_ok)


@spans.spanned("solver.line_search")
def _line_search(spec, settings, params, xs, us, cost, bp, fs, feasible,
                 alphas, ddp: bool, box: bool):
    """Every rolled-out candidate under the accept rule. Returns (accepted
    (B, A), xs_try, us_try, cost_try)."""
    dg, dq = _expected_improvement_terms(bp, fs, feasible)
    xs_t, us_t, cost_t, dvg = _forward_pass_multi(
        spec, settings, params, xs, us, bp, fs, alphas, feasible, ddp, box)
    if ddp:
        d0, d1 = dg[:, None], dq[:, None]
    else:
        d0, d1 = _expected_improvement(spec, bp, fs, xs, xs_t, dg, dq,
                                       feasible)
    acc = _accept(settings, ddp, feasible, alphas, d0, d1,
                  cost[:, None] - cost_t)
    return acc & ~dvg, xs_t, us_t, cost_t


def _take_first(acc, alphas, xs, us, cost, xs_t, us_t, cost_t):
    """The first accepted alpha per element: (any accepted, xs, us, cost,
    steplength), the element unchanged (steplength the last alpha) where
    none was."""
    any_accept = acc.any(dim=1)
    idx = torch.argmax(acc.to(torch.uint8), dim=1)
    ar = torch.arange(acc.shape[0], device=acc.device)
    return (any_accept,
            torch.where(_bcast(any_accept, xs), xs_t[ar, idx], xs),
            torch.where(_bcast(any_accept, us), us_t[ar, idx], us),
            torch.where(any_accept, cost_t[ar, idx], cost),
            torch.where(any_accept, alphas[idx], alphas[-1]))


def _stop_test(settings, ddp, th_stop, any_accept, cost, cost_new, stop_prev,
               feas_new, gap_norm):
    """Cost-reduction stopping criterion with the gap test: (stop_val,
    done)."""
    stop_val = torch.where(any_accept, cost - cost_new, stop_prev)
    if settings.crocoddyl_signed_stop:
        small_red = stop_val < th_stop
    else:
        small_red = (stop_val >= 0) & (stop_val < th_stop)
    done = any_accept & small_red & (
        feas_new if ddp else gap_norm < settings.th_stop_gaps)
    return stop_val, done


def _alphas(settings, n_alphas, like):
    return _alpha_ladder(settings.alphas[:n_alphas], like.dtype, like.device)


@functools.lru_cache(maxsize=32)
def _alpha_ladder(alphas, dtype, device):
    """The alpha ladder as a device constant, made once (a tensor made from
    host data inside a captured tick would be a pageable copy)."""
    return torch.tensor(alphas, dtype=dtype, device=device)


def _budget(maxiter, B: int, device):
    """Per-element iteration budgets (B,) from an int or a (B,) tensor;
    an int becomes a fill, not a copy from the host."""
    if isinstance(maxiter, torch.Tensor):
        return maxiter.to(device).expand(B)
    return torch.full((B,), int(maxiter), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# The while-loop solver (the offline path)
# ---------------------------------------------------------------------------

def _while_iteration(spec, settings, params, s: _Carry, ddp: bool, th_stop,
                     box: bool, phase_id: int, sync_free: bool,
                     n_retries: int, *, active) -> _Carry:
    """One iteration of the reference's solve loop: a direction with the
    escalation retried inside, the line search, the step-length
    regularization schedule and the stopping test. ``active``: the
    elements whose result the caller keeps."""
    alphas = _alphas(settings, settings.n_alphas, s.xs)
    cost, fs, bp, xreg, ureg, failed = _compute_direction(
        spec, settings, params, s.xs, s.us, s.feasible, s.xreg, s.ureg, box,
        sync_free, n_retries, active=active)
    gap_norm = fs.abs().amax(dim=(1, 2))
    acc, xs_t, us_t, cost_t = _line_search(
        spec, settings, params, s.xs, s.us, cost, bp, fs, s.feasible, alphas,
        ddp, box)
    any_accept, xs_new, us_new, cost_new, steplength = _take_first(
        acc, alphas, s.xs, s.us, cost, xs_t, us_t, cost_t)
    if ddp:
        feas_new = any_accept | s.feasible
    else:
        feas_new = torch.where(any_accept, s.feasible | (steplength == 1.0),
                               s.feasible)

    f, lo, hi = settings.reg_factor, settings.reg_min, settings.reg_max
    dec = steplength > settings.th_stepdec
    inc = steplength <= settings.th_stepinc
    xreg = torch.where(dec, torch.clamp(xreg / f, min=lo), xreg)
    xreg = torch.where(inc, torch.clamp(xreg * f, max=hi), xreg)
    ureg = torch.where(dec, torch.clamp(ureg / f, min=lo), ureg)
    ureg = torch.where(inc, torch.clamp(ureg * f, max=hi), ureg)
    failed = failed | (inc & (xreg >= hi))
    stop_val, done = _stop_test(settings, ddp, th_stop, any_accept, cost,
                                cost_new, s.stop_val, feas_new, gap_norm)

    trace = s.trace
    if trace is not None:
        ar = torch.arange(s.it.shape[0], device=s.it.device)
        row = s.it.long().clamp(max=trace.cost.shape[1] - 1)

        def put(a, v):
            a = a.clone()
            a[ar, row] = v.to(a.dtype)
            return a
        trace = IterTrace(
            cost=put(trace.cost, cost_new), stop=put(trace.stop, stop_val),
            steplength=put(trace.steplength, steplength),
            xreg=put(trace.xreg, xreg), gap_norm=put(trace.gap_norm, gap_norm),
            accepted=put(trace.accepted, any_accept),
            phase=put(trace.phase, torch.full_like(row, phase_id)))
    return _Carry(xs=xs_new, us=us_new, cost=cost_new, feasible=feas_new,
                  xreg=xreg, ureg=ureg, it=s.it + 1, stop_val=stop_val,
                  gap_norm=gap_norm, done=done, failed=failed, trace=trace)


def solve_fddp_or_ddp(spec, settings: SolverSettings, params, xs_init, us_init,
                      maxiter, th_stop, reg_init=1e-9, feasible_init=False, *,
                      ddp: bool, box: bool = False,
                      trace_len: Optional[int] = None,
                      phase_id: int = 0,
                      final_cost_fallback: bool = True,
                      sync_free: Optional[int] = None) -> SolveResult:
    """The reference's FDDP (gap-aware) or DDP solve over a batch: params
    batched, xs_init (B, T+1, nx), us_init (B, T, nu); ``maxiter`` an int
    or (B,) budgets. Iterates while any element is active (it < maxiter,
    not done, not failed); an element that stops is frozen. The host tests
    once per iteration whether any element is active.

    ``sync_free``: None (the host tests), or a static bound on the budgets
    (an int >= max ``maxiter``): then exactly that many masked iterations
    run, each with the escalation's static bound, and nothing is read on
    the host; the result is the same bit for bit.

    With ``settings.record_trace`` an :class:`IterTrace` of ``trace_len``
    rows (default ``maxiter``, which must then be an int) comes back in
    ``SolveResult.trace``, its rows labelled ``phase_id``. With
    ``final_cost_fallback`` an element that never iterates gets the cost of
    its candidate without a rollout (``problem.total_cost``); without it,
    ``inf``."""
    P.check_scope(spec)
    full_precision_matmul()
    s = _init_carry(xs_init, us_init, reg_init, feasible_init)
    if settings.record_trace:
        if trace_len is None:
            if not isinstance(maxiter, int):
                raise ValueError("record_trace needs a trace length: pass an "
                                 "int maxiter or trace_len")
            trace_len = maxiter
        s = s._replace(trace=_empty_trace(xs_init.shape[0], trace_len,
                                          xs_init.dtype, xs_init.device))
    if isinstance(sync_free, bool):
        raise TypeError("sync_free takes the static bound on the budgets "
                        "(an int) or None")
    budget = _budget(maxiter, xs_init.shape[0], xs_init.device)
    free = sync_free is not None
    n_retries = escalation_bound(settings, min(reg_init, settings.reg_min),
                                 xs_init.dtype)
    i = 0
    while not free or i < sync_free:
        active = (s.it < budget) & ~s.done & ~s.failed
        if not free and not bool(active.any()):
            break
        with spans.span("solver.iteration"):
            spans.count(spans.ITERATIONS, active)
            s = _select(active, _while_iteration(
                spec, settings, params, s, ddp, th_stop, box, phase_id, free,
                n_retries, active=active), s)
        i += 1
    return _result(s, spec, params, final_cost_fallback, free)


def solve_fddp(spec, settings, params, xs_init, us_init, maxiter, th_stop,
               reg_init=1e-9, feasible=False, trace_len=None, phase_id=0):
    return solve_fddp_or_ddp(spec, settings, params, xs_init, us_init,
                             maxiter, th_stop, reg_init, feasible, ddp=False,
                             trace_len=trace_len, phase_id=phase_id)


def solve_ddp(spec, settings, params, xs_init, us_init, maxiter, th_stop,
              reg_init=1e-9, feasible=False, trace_len=None, phase_id=0):
    return solve_fddp_or_ddp(spec, settings, params, xs_init, us_init,
                             maxiter, th_stop, reg_init, feasible, ddp=True,
                             trace_len=trace_len, phase_id=phase_id)


def solve_box_fddp(spec, settings, params, xs_init, us_init, maxiter, th_stop,
                   reg_init=1e-9, feasible=False):
    """Box-FDDP (Crocoddyl's SolverBoxFDDP): gap-aware FDDP with box-QP
    gains and clipped rollouts. The bounds are ``params.glob.s_lb/s_ub``;
    the spec must not squash (``use_squash=False``)."""
    return solve_fddp_or_ddp(spec, settings, params, xs_init, us_init,
                             maxiter, th_stop, reg_init, feasible, ddp=False,
                             box=True)


def solve_box_ddp(spec, settings, params, xs_init, us_init, maxiter, th_stop,
                  reg_init=1e-9, feasible=False):
    """Box-DDP (Crocoddyl's SolverBoxDDP): the plain-rollout variant."""
    return solve_fddp_or_ddp(spec, settings, params, xs_init, us_init,
                             maxiter, th_stop, reg_init, feasible, ddp=True,
                             box=True)


# ---------------------------------------------------------------------------
# The fixed iteration (the MPC tick)
# ---------------------------------------------------------------------------

def _check_fixed_settings(settings: SolverSettings) -> None:
    """The fixed-depth path always runs the sequential pass (K3); silently
    ignoring ``parallel_riccati`` would give a caller another pass than the
    one asked for."""
    if settings.parallel_riccati:
        raise ValueError(
            "parallel_riccati is not supported on the fixed-depth solver "
            "path (solve_fixed / solve_while_fixed_body / sbfddp.solve_fixed)"
            " — it always uses the sequential pass (kernel K3). Use "
            "solve_fddp_or_ddp for the log-depth scan.")


def _fixed_iteration(spec, settings, params, s: _Carry, ddp: bool, th_stop,
                     n_alphas: int, box: bool = False) -> _Carry:
    """One fixed-shape iteration: a failed backward pass escalates the
    regularization and consumes the iteration (escalate-and-continue)
    instead of re-running the pass."""
    alphas = _alphas(settings, n_alphas, s.xs)
    derivs, term, cost, fs, derivs_ok = _linearize(spec, params, s.xs, s.us,
                                                   s.feasible)
    gap_norm = fs.abs().amax(dim=(1, 2))
    bp = _backward_pass(spec, derivs, term, fs, s.xreg, s.ureg, s.feasible,
                        _box_info(settings, params, s.us, box))
    bp_ok = bp.ok & derivs_ok
    acc, xs_t, us_t, cost_t = _line_search(
        spec, settings, params, s.xs, s.us, cost, bp, fs, s.feasible, alphas,
        ddp, box)
    any_accept, xs_new, us_new, cost_new, steplength = _take_first(
        acc & bp_ok[:, None], alphas, s.xs, s.us, cost, xs_t, us_t, cost_t)
    if ddp:
        feas_new = any_accept | s.feasible
    else:
        feas_new = torch.where(any_accept, s.feasible | (steplength == 1.0),
                               s.feasible)

    # regularization schedule; a failed backward pass escalates
    dec = bp_ok & (steplength > settings.th_stepdec)
    inc = (bp_ok & (steplength <= settings.th_stepinc)) | ~bp_ok
    f, lo, hi = settings.reg_factor, settings.reg_min, settings.reg_max
    xreg = torch.where(dec, torch.clamp(s.xreg / f, min=lo), s.xreg)
    xreg = torch.where(inc, torch.clamp(xreg * f, max=hi), xreg)
    ureg = torch.where(dec, torch.clamp(s.ureg / f, min=lo), s.ureg)
    ureg = torch.where(inc, torch.clamp(ureg * f, max=hi), ureg)
    failed = ~derivs_ok | (inc & (xreg >= hi))
    stop_val, done = _stop_test(settings, ddp, th_stop, any_accept, cost,
                                cost_new, s.stop_val, feas_new, gap_norm)
    return _Carry(xs=xs_new, us=us_new, cost=cost_new, feasible=feas_new,
                  xreg=xreg, ureg=ureg, it=s.it + 1, stop_val=stop_val,
                  gap_norm=gap_norm, done=done, failed=failed)


def _init_carry(xs, us, reg_init, feasible_init) -> _Carry:
    B, dtype, device = xs.shape[0], xs.dtype, xs.device
    full = lambda v: torch.full((B,), v, dtype=dtype, device=device)
    false = torch.zeros(B, dtype=torch.bool, device=device)
    if feasible_init is None:
        feas = false
    elif isinstance(feasible_init, torch.Tensor):
        feas = feasible_init.to(device).expand(B).clone()
    else:
        feas = torch.full((B,), bool(feasible_init), device=device)
    return _Carry(xs=xs, us=us, cost=full(float("inf")), feasible=feas,
                  xreg=full(reg_init), ureg=full(reg_init),
                  it=torch.zeros(B, dtype=torch.int32, device=device),
                  stop_val=full(float("inf")), gap_norm=full(float("inf")),
                  done=false, failed=false.clone())


def _result(s: _Carry, spec=None, params=None,
            final_cost_fallback: bool = False,
            sync_free: bool = False) -> SolveResult:
    """The solve's result; with ``final_cost_fallback`` an element that never
    iterated (its cost still inf) gets ``problem.total_cost`` of its
    candidate (computed whatever the costs under ``sync_free``)."""
    cost = s.cost
    if final_cost_fallback and (sync_free
                                or not bool(torch.isfinite(cost).all())):
        cost = torch.where(torch.isfinite(cost), cost,
                           P.total_cost(spec, params, s.xs, s.us))
    return SolveResult(xs=s.xs, us=s.us, cost=cost, iters=s.it,
                       feasible=s.feasible, stop=s.stop_val,
                       gap_norm=s.gap_norm, xreg=s.xreg, failed=s.failed,
                       trace=s.trace)


def solve_fixed(spec, settings: SolverSettings, params, xs, us, depth: int,
                th_stop: float, reg_init: float = 1e-9, feasible_init=None, *,
                ddp: bool = False, box: bool = False, maxiter=None,
                n_alphas: Optional[int] = None,
                final_cost_fallback: bool = True,
                sync_free: bool = False) -> SolveResult:
    """``depth`` iterations with per-element done/maxiter masking (the
    reference package's ``solve_fixed_batched``). ``maxiter``: None (=
    depth) or a (B,) budget. Iterations after every element has stopped are
    skipped; they would change nothing. With ``sync_free`` all ``depth``
    run, masked, and nothing is read on the host. ``final_cost_fallback``
    as in :func:`solve_fddp_or_ddp`. ``settings.parallel_riccati`` raises
    ``ValueError``."""
    _check_fixed_settings(settings)
    P.check_scope(spec)
    full_precision_matmul()
    n_alphas = settings.n_alphas if n_alphas is None else n_alphas
    s = _init_carry(xs, us, reg_init, feasible_init)
    budget = _budget(depth if maxiter is None else maxiter, xs.shape[0],
                     xs.device)
    for i in range(depth):
        active = ~s.done & ~s.failed & (i < budget)
        if not sync_free and not bool(active.any()):
            break
        with spans.span("solver.iteration"):
            spans.count(spans.ITERATIONS, active)
            spans.count(spans.PASSES, active)
            s = _select(active, _fixed_iteration(
                spec, settings, params, s, ddp, th_stop, n_alphas, box), s)
    return _result(s, spec, params, final_cost_fallback, sync_free)


def solve_while_fixed_body(spec, settings: SolverSettings, params, xs, us,
                           maxiter, th_stop: float, reg_init: float = 1e-9,
                           feasible_init=None, *, ddp: bool = False,
                           box: bool = False,
                           n_alphas: Optional[int] = None) -> SolveResult:
    """Early-exit loop over the fixed iteration: runs while any element is
    active (it < maxiter, not done, not failed), each element frozen once
    it stops. ``maxiter``: (B,) budgets. ``settings.parallel_riccati``
    raises ``ValueError``."""
    _check_fixed_settings(settings)
    P.check_scope(spec)
    full_precision_matmul()
    n_alphas = settings.n_alphas if n_alphas is None else n_alphas
    s = _init_carry(xs, us, reg_init, feasible_init)
    while True:
        active = (s.it < maxiter) & ~s.done & ~s.failed
        if not bool(active.any()):
            break
        with spans.span("solver.iteration"):
            spans.count(spans.ITERATIONS, active)
            spans.count(spans.PASSES, active)
            s = _select(active, _fixed_iteration(
                spec, settings, params, s, ddp, th_stop, n_alphas, box), s)
    return _result(s)


def default_init(spec, params):
    """x0 replicated, zero controls: (B, T+1, nx), (B, T, nu)."""
    x0 = params.x0
    xs = x0[:, None].expand(x0.shape[0], spec.T + 1, x0.shape[1]).clone()
    us = torch.zeros(x0.shape[0], spec.T, spec.nu, dtype=x0.dtype,
                     device=x0.device)
    return xs, us
