"""Time-parallel Riccati backward pass: a log-depth suffix scan over T.

PyTorch counterpart of ``eagle_mpc_tpu.solvers.priccati``, over an
explicit leading batch. The sequential recursion (kernel K3) takes T
dependent steps. Here each node instead becomes an element, the
conditional cost-to-go between two times as a quadratic in the boundary
states, 5-tuple (A, b, C, eta, J); two adjacent elements compose
associatively by minimizing over the state they share (the
temporal-parallelization-of-LQT construction). The suffix products
e_t o e_{t+1} o ... o e_T are every node's value function (Vx, Vxx) at
once, and the gains follow from them with the sequential pass's formulas.

Eliminating u with the STAGE Hessian (Luu + ureg) when an element is
built, and then minimizing over the interior states, commutes with the
interleaved elimination of the sequential recursion, so (Vx, Vxx) and the
gains match ``fddp._backward_pass`` to round-off. The sequential pass's
PD floor (100 eps of Quu's largest diagonal entry) is not applied here,
as in the reference package.

The suffix scan is written out (:func:`_suffix_scan`): about 2 log2(T+1)
levels, each one :func:`_combine` on all of that level's pairs batched
over (B, pairs); no Python loop runs over T. This module is plain
PyTorch (the reference computes it in XLA, outside its kernels), so the
batched LU and Cholesky routines of the library do the small solves. A
stage Hessian that is not positive definite gives NaN through
``smallmat`` (never an exception) and ``ok`` False for its element only.
Enabled on the while-loop solver by ``SolverSettings(parallel_riccati=
True)``; the fixed-depth path refuses the flag.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ocp import problem as P
from ..ops.smallmat import CholFactor
from .fddp import BackwardPassData, _all_finite


class _Element(NamedTuple):
    """Conditional cost-to-go between two horizon times, leaves (..., n, n)
    or (..., n): after the full suffix product V(x) = 0.5 x' J x - eta' x."""

    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _sym(M):
    return 0.5 * (M + M.mT)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _combine(ei: _Element, ej: _Element) -> _Element:
    """Associative composition of adjacent elements (ei the earlier),
    batched over every leading axis. Minimizes over the shared state: one
    LU of M = I + C_i J_j serves the solve with M and, transposed, the one
    with M' = I + J_j C_i."""
    n = ei.A.shape[-1]
    eye = torch.eye(n, dtype=ei.A.dtype, device=ei.A.device)
    LU, piv, _ = torch.linalg.lu_factor_ex(eye + ei.C @ ej.J)
    sol = torch.linalg.lu_solve(LU, piv, torch.cat(
        [ei.A, (ei.b + _mv(ei.C, ej.eta))[..., None], ei.C], dim=-1))
    MA, Mb, MC = sol[..., :n], sol[..., n], sol[..., n + 1:]
    sol_t = torch.linalg.lu_solve(LU, piv, torch.cat(
        [(ej.eta - _mv(ej.J, ei.b))[..., None], ej.J], dim=-1), adjoint=True)
    Ne, NJ = sol_t[..., 0], sol_t[..., 1:]
    AiT = ei.A.mT
    return _Element(A=ej.A @ MA, b=_mv(ej.A, Mb) + ej.b,
                    C=_sym(ej.A @ MC @ ej.A.mT + ej.C),
                    eta=_mv(AiT, Ne) + ei.eta,
                    J=_sym(AiT @ NJ @ ei.A + ei.J))


def _stage_elements(derivs, fs_next, xreg, ureg) -> _Element:
    """Per-node elements (B, T, ...): u eliminated with the stage Hessian,
    the gap folded into the affine term. xreg, ureg (B,)."""
    nu, ndx = derivs.Lu.shape[-1], derivs.Lx.shape[-1]
    dtype, device = derivs.Lx.dtype, derivs.Lx.device
    I_nu = torch.eye(nu, dtype=dtype, device=device)
    I_nx = torch.eye(ndx, dtype=dtype, device=device)
    chol = CholFactor(derivs.Luu + ureg[:, None, None, None] * I_nu)
    Ki = chol.solve_mat(derivs.Lxu.mT)           # Luu^-1 Lux
    ki = chol.solve(derivs.Lu)                   # Luu^-1 Lu
    Ci = chol.solve_mat(derivs.Fu.mT)
    Fu = derivs.Fu
    return _Element(A=derivs.Fx - Fu @ Ki, b=fs_next - _mv(Fu, ki),
                    C=_sym(Fu @ Ci), eta=-(derivs.Lx - _mv(derivs.Lxu, ki)),
                    J=_sym(derivs.Lxx - derivs.Lxu @ Ki)
                    + xreg[:, None, None, None] * I_nx)


def _take(e: _Element, index) -> _Element:
    return _Element(*(a[:, index] for a in e))


def _cat(*es: _Element) -> _Element:
    return _Element(*(torch.cat(parts, dim=1) for parts in zip(*es)))


def _suffix_scan(e: _Element) -> _Element:
    """out[t] = e[t] o e[t+1] o ... o e[N-1] along axis 1 (N nodes): pairs
    (2i, 2i+1) are combined, the reduced sequence is scanned, and the odd
    positions take their partner's suffix: one combine per level on the
    way down and one on the way up."""
    N = e.A.shape[1]
    if N == 1:
        return e
    half = N // 2
    red = _combine(_take(e, slice(0, 2 * half, 2)),
                   _take(e, slice(1, 2 * half, 2)))
    if N % 2:
        red = _cat(red, _take(e, slice(N - 1, N)))
    sub = _suffix_scan(red)                # sub[i]: the suffix from 2i
    # the odd position 2i+1 is e[2i+1] o sub[i+1]; the last one, when N is
    # even, is e[N-1] alone
    n_odd = (N - 1) // 2
    parts = [_combine(_take(e, slice(1, 2 * n_odd, 2)),
                      _take(sub, slice(1, None)))] if n_odd else []
    if N % 2 == 0:
        parts.append(_take(e, slice(N - 1, N)))
    odd = _cat(*parts)
    even = _take(sub, slice(0, (N + 1) // 2))
    # interleave: even[0], odd[0], even[1], ...
    out = []
    for ev, od in zip(even, odd):
        pad = ev.shape[1] - od.shape[1]
        if pad:
            od = torch.cat([od, ev[:, :pad]], dim=1)
        both = torch.stack([ev, od], dim=2)
        out.append(both.reshape(ev.shape[0], -1, *ev.shape[2:])[:, :N])
    return _Element(*out)


def parallel_backward_pass(spec, derivs, term, fs, xreg, ureg,
                           feasible) -> BackwardPassData:
    """Drop-in replacement for the sequential ``fddp._backward_pass``
    without the box QP: derivatives (B, T, ...), terminal (cost, Lx, Lxx),
    gaps fs (B, T+1, ndx), per-element xreg, ureg, feasible (B,). ``ok``
    is per element."""
    ndx = spec.state.ndx
    _, LxT, LxxT = term
    B, dtype, device = LxT.shape[0], LxT.dtype, LxT.device
    I_ndx = torch.eye(ndx, dtype=dtype, device=device)
    I_nu = torch.eye(spec.nu, dtype=dtype, device=device)

    zeros = torch.zeros(B, 1, ndx, ndx, dtype=dtype, device=device)
    term_elem = _Element(A=zeros, b=torch.zeros(B, 1, ndx, dtype=dtype,
                                                device=device),
                         C=zeros, eta=-LxT[:, None],
                         J=(LxxT + xreg[:, None, None] * I_ndx)[:, None])
    suffix = _suffix_scan(_cat(_stage_elements(derivs, fs[:, 1:], xreg, ureg),
                               term_elem))

    Vxx = suffix.J                                         # (B, T+1, n, n)
    gap = _mv(Vxx, fs)
    Vx = -suffix.eta + torch.where(feasible[:, None, None],
                                   torch.zeros_like(gap), gap)

    # per-node gains from V_{t+1}, the sequential pass's formulas
    Vx1, Vxx1 = Vx[:, 1:], Vxx[:, 1:]
    FuT = derivs.Fu.mT
    Qu = derivs.Lu + _mv(FuT, Vx1)
    Qxu = derivs.Lxu + (derivs.Fx.mT @ Vxx1) @ derivs.Fu
    Quu = derivs.Luu + FuT @ Vxx1 @ derivs.Fu + ureg[:, None, None, None] * I_nu
    chol = CholFactor(Quu)
    k = chol.solve(Qu)
    K = chol.solve_mat(Qxu.mT)
    ok = _all_finite(k) & _all_finite(K) & _all_finite(Vx)
    return BackwardPassData(k=k, K=K, Qu=Qu, Quuk=_mv(Quu, k), Vx=Vx, Vxx=Vxx,
                            ok=ok)


def random_lqr(B: int, T: int, ndx: int, nu: int, seed: int,
               dtype=torch.float64, device="cpu"):
    """Seeded random (derivs, term, fs) of a stable LQR subproblem with
    positive definite stage Hessians, drawn on ``device``: inputs for
    holding :func:`parallel_backward_pass` against the sequential pass, and
    for timing both, at any horizon."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=dtype, device=device)
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    spd = lambda n, s: (lambda M: M @ M.mT / n + s * eye(n))(r(B, T, n, n))
    derivs = P.NodeDerivatives(
        cost=r(B, T), xnext=r(B, T, ndx), Fx=eye(ndx) + 0.02 * r(B, T, ndx, ndx),
        Fu=0.1 * r(B, T, ndx, nu), Lx=r(B, T, ndx), Lu=r(B, T, nu),
        Lxx=spd(ndx, 0.5), Lxu=0.05 * r(B, T, ndx, nu), Luu=spd(nu, 0.5))
    term = (r(B), r(B, ndx), spd(ndx, 1.0)[:, 0].contiguous())
    return derivs, term, 0.01 * r(B, T + 1, ndx)
