"""Riccati backward pass over a batch (kernel K3, csrc/riccati.cu).

``backward`` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch recursion, ``backward_plain``, for CPU tensors. There is no
fallback: a CUDA call either launches or raises.
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


@spans.spanned("k3")
def backward(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT, xreg, ureg,
             feasible):
    """Same signature and result as :func:`backward_plain`."""
    if Lx.device.type == "cpu":
        return backward_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, VxT, VxxT,
                              xreg, ureg, feasible)
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
    feas = feasible.to(torch.bool).contiguous().view(torch.uint8)
    _cuda.check_tensor(feas, "feasible", (B,), torch.uint8, dev)
    e = lambda *shape: torch.empty((B, T) + shape, dtype=dt, device=dev)
    out = (e(nu), e(nu, ndx), e(nu), e(nu), e(ndx), e(ndx, ndx))
    rel_eps = 100.0 * torch.finfo(dt).eps
    _cuda.call("eagle_riccati", dt, B, T, ndx, nu, rel_eps,
               *(a.data_ptr() for a in [t for t, _, _ in ins] + [feas, *out]))
    LAUNCHES += 1
    return out
