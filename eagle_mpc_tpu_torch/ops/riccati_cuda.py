"""Riccati backward pass over a batch (kernel K3, csrc/riccati.cu).

``backward`` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch recursion, ``backward_plain``, for CPU tensors.
``backward_escalating`` adds the regularization escalation of the
reference's direction (a do-while per problem: a failed pass reruns at
regularization times reg_factor until it is ok or reaches reg_max); the
kernel runs each problem's rounds itself in one launch, and CPU tensors
take ``backward_escalating_plain``, the masked rounds on the host. There is
no fallback: a CUDA call either launches or raises.
"""

from __future__ import annotations

import torch

from ..utils import spans
from . import _cuda
from .smallmat import CholFactor

#: kernel launches since the last reset (the plain path does not count)
LAUNCHES = 0


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _all_finite(a):
    return torch.isfinite(a).flatten(1).all(dim=1)


def terminal_value(LxT, LxxT, fT, xreg, feasible):
    """The terminal value the recursion starts from: VxxT = LxxT + xreg I,
    VxT = LxT (+ VxxT fT where infeasible). Returns (VxT, VxxT)."""
    eye = torch.eye(LxT.shape[-1], dtype=LxT.dtype, device=LxT.device)
    VxxT = LxxT + xreg[:, None, None] * eye
    VxT = LxT + torch.where(feasible[:, None], torch.zeros_like(LxT),
                            (VxxT @ fT[..., None])[..., 0])
    return VxT, VxxT


def backward_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT, xreg, ureg,
                   feasible, gains=None):
    """Reverse recursion over T, batched over B (the reference's
    ``fddp._backward_pass`` step). Inputs (B, T, ...) plus the terminal
    (VxT, VxxT) and per-problem xreg/ureg/feasible (B,). Returns (k, K, Qu,
    Quuk, Vx, Vxx) of the running nodes, (B, T, ...).

    ``gains(t, Quu, Qu, Qxu) -> (k, K)`` replaces the Cholesky gains (the
    Box-DDP pass of ``solvers.fddp``, which has no kernel)."""
    B, T, ndx = Lx.shape
    nu = Lu.shape[-1]
    dtype, device = Lx.dtype, Lx.device
    I_ndx = torch.eye(ndx, dtype=dtype, device=device)
    I_nu = torch.eye(nu, dtype=dtype, device=device)
    rel_eps = 100.0 * torch.finfo(dtype).eps
    Vx, Vxx = VxT, VxxT
    outs = []
    for t in reversed(range(T)):
        fx, fu = Fx[:, t], Fu[:, t]
        FxTV = fx.mT @ Vxx
        FuTV = fu.mT @ Vxx
        Qx = Lx[:, t] + _mv(fx.mT, Vx)
        Qu = Lu[:, t] + _mv(fu.mT, Vx)
        Qxx = Lxx[:, t] + FxTV @ fx
        Qxu = Lxu[:, t] + FxTV @ fu
        Quu_raw = Luu[:, t] + FuTV @ fu
        floor = rel_eps * Quu_raw.diagonal(dim1=-2, dim2=-1).abs().amax(dim=-1)
        Quu = Quu_raw + (ureg + floor)[:, None, None] * I_nu
        if gains is None:
            chol = CholFactor(Quu)
            k = chol.solve(Qu)
            K = chol.solve_mat(Qxu.mT)
        else:
            k, K = gains(t, Quu, Qu, Qxu)
        Quuk = _mv(Quu, k)
        Vx = Qx + _mv(K.mT, Quuk) - 2.0 * _mv(K.mT, Qu)
        Vxx = Qxx - Qxu @ K
        Vxx = 0.5 * (Vxx + Vxx.mT) + xreg[:, None, None] * I_ndx
        Vx = Vx + torch.where(feasible[:, None], torch.zeros_like(Vx),
                              _mv(Vxx, fs[:, t]))
        outs.append((k, K, Qu, Quuk, Vx, Vxx))
    return tuple(torch.stack(o[::-1], dim=1) for o in zip(*outs))


def backward_escalating_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT,
                              xreg, ureg, feasible, derivs_ok, reg_factor,
                              reg_max, max_retries: int,
                              sync_free: bool = False):
    """The plain version of :func:`backward_escalating`: the first pass at
    (xreg, ureg), then rounds over the batch: a row whose pass failed
    (k, K, Vx or VxT not all finite) with ``derivs_ok`` and xreg below
    ``reg_max`` retries at both regularizations times ``reg_factor``
    (clamped at ``reg_max``) and keeps the new pass. At most
    ``max_retries`` rounds; without ``sync_free`` they stop once no row
    retries (a test on the host)."""
    VxT, VxxT = terminal_value(LxT, LxxT, fs[:, -1], xreg, feasible)

    def run(xr, ur, VxT, VxxT):
        out = backward_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs[:, :-1], VxT,
                             VxxT, xr, ur, feasible)
        ok = (_all_finite(out[0]) & _all_finite(out[1])
              & _all_finite(out[4]) & _all_finite(VxT))
        return out + (VxT, VxxT, ok)

    res = run(xreg, ureg, VxT, VxxT)
    passes = torch.ones_like(xreg, dtype=torch.int32)
    for _ in range(max_retries):
        retry = ~res[-1] & derivs_ok & (xreg < reg_max)
        if not sync_free and not bool(retry.any()):
            break
        xreg = torch.where(retry, torch.clamp(xreg * reg_factor, max=reg_max),
                           xreg)
        ureg = torch.where(retry, torch.clamp(ureg * reg_factor, max=reg_max),
                           ureg)
        new = run(xreg, ureg, *terminal_value(LxT, LxxT, fs[:, -1], xreg,
                                              feasible))
        res = tuple(torch.where(retry.reshape((-1,) + (1,) * (a.ndim - 1)),
                                a, b) for a, b in zip(new, res))
        passes = passes + retry.to(torch.int32)
    return res[:-1] + (xreg, ureg, res[-1], passes)


def _launch(entry, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT, xreg, ureg,
            feasible, *extra):
    """Check the one-pass arguments, allocate (k, K, Qu, Quuk, Vx, Vxx) and
    launch the C entry ``entry`` with ``extra`` (pointers and scalars)
    after them."""
    global LAUNCHES
    _cuda.require_cuda(Lx)
    B, T, ndx = Lx.shape
    nu = Lu.shape[-1]
    if ndx > 2 * _cuda.MAX_NV or nu > _cuda.MAX_NU:
        raise NotImplementedError(f"ndx {ndx} / nu {nu} exceed the kernel's maxima")
    dt, dev = Lx.dtype, Lx.device
    ins = [(Fx, "Fx", (B, T, ndx, ndx)), (Fu, "Fu", (B, T, ndx, nu)),
           (Lx, "Lx", (B, T, ndx)), (Lu, "Lu", (B, T, nu)),
           (Lxx, "Lxx", (B, T, ndx, ndx)), (Lxu, "Lxu", (B, T, ndx, nu)),
           (Luu, "Luu", (B, T, nu, nu)), (fs.contiguous(), "fs", (B, T, ndx)),
           (VxT.contiguous(), "VxT", (B, ndx)),
           (VxxT.contiguous(), "VxxT", (B, ndx, ndx)),
           (xreg.contiguous(), "xreg", (B,)), (ureg.contiguous(), "ureg", (B,))]
    for t, name, shape in ins:
        _cuda.check_tensor(t, name, shape, dt, dev)
    feas = _flags(feasible, "feasible")
    e = lambda *shape: torch.empty((B, T) + shape, dtype=dt, device=dev)
    out = (e(nu), e(nu, ndx), e(nu), e(nu), e(ndx), e(ndx, ndx))
    rel_eps = 100.0 * torch.finfo(dt).eps
    _cuda.call(entry, dt, B, T, ndx, nu, rel_eps,
               *(a.data_ptr() for a in [t for t, _, _ in ins] + [feas, *out]),
               *extra)
    LAUNCHES += 1
    return out


def _flags(mask, name):
    """A (B,) mask as the kernel's bytes."""
    flags = mask.to(torch.bool).contiguous().view(torch.uint8)
    _cuda.check_tensor(flags, name, mask.shape[:1], torch.uint8, mask.device)
    return flags


@spans.spanned("k3")
def backward(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT, xreg, ureg,
             feasible):
    """Same signature and result as :func:`backward_plain`."""
    if Lx.device.type == "cpu":
        return backward_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT,
                              xreg, ureg, feasible)
    return _launch("eagle_riccati", Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT,
                   VxxT, xreg, ureg, feasible)


@spans.spanned("k3")
def backward_escalating(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, xreg,
                        ureg, feasible, derivs_ok, reg_factor, reg_max,
                        max_retries: int, sync_free: bool = False):
    """The backward pass with the reference's regularization escalation,
    per problem: rerun at both regularizations times ``reg_factor``
    (clamped at ``reg_max``) while the pass failed (k, K, Vx or the
    terminal VxT not all finite), ``derivs_ok`` holds and xreg is below
    ``reg_max``, at most ``max_retries`` times. ``fs`` (B, T+1, ndx) holds
    the terminal gap; the terminal value of each pass is
    :func:`terminal_value` at that pass's xreg. Returns (k, K, Qu, Quuk,
    Vx, Vxx) of the running nodes, (VxT, VxxT) of each row's last pass,
    the final (xreg, ureg), ok (B,) bool and the passes each row ran (B,)
    int32.

    One kernel launch: a problem's group of warps runs its own rounds. The
    first pass reads the terminal value built here, so a row that does not
    retry gets :func:`backward`'s result bit for bit; a retried row's
    terminal value is rebuilt in the kernel (its VxT sums in another order
    than the product here). ``sync_free`` matters only to the plain
    version."""
    if Lx.device.type == "cpu":
        return backward_escalating_plain(
            Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, xreg, ureg,
            feasible, derivs_ok, reg_factor, reg_max, max_retries, sync_free)
    B, T, ndx = Lx.shape
    dt, dev = Lx.dtype, Lx.device
    _cuda.check_tensor(fs, "fs", (B, T + 1, ndx), dt, dev)
    # the first pass's terminal value; the kernel writes each retried
    # row's last one over it (so these must be the tensors it is given)
    VxT, VxxT = (a.contiguous() for a in
                 terminal_value(LxT, LxxT, fs[:, -1], xreg, feasible))
    esc = [(LxT.contiguous(), "LxT", (B, ndx)),
           (LxxT.contiguous(), "LxxT", (B, ndx, ndx)),
           (fs[:, -1].contiguous(), "fT", (B, ndx))]
    for t, name, shape in esc:
        _cuda.check_tensor(t, name, shape, dt, dev)
    dok = _flags(derivs_ok, "derivs_ok")
    xreg_o, ureg_o = torch.empty_like(xreg), torch.empty_like(ureg)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    passes = torch.empty(B, dtype=torch.int32, device=dev)
    out = _launch("eagle_riccati_escalating", Fx, Fu, Lx, Lu, Lxx, Lxu, Luu,
                  fs[:, :-1], VxT, VxxT, xreg, ureg, feasible,
                  *(t.data_ptr() for t, _, _ in esc), dok.data_ptr(),
                  reg_factor, reg_max, int(max_retries), xreg_o.data_ptr(),
                  ureg_o.data_ptr(), ok.data_ptr(), passes.data_ptr())
    return out + (VxT, VxxT, xreg_o, ureg_o, ok, passes)
