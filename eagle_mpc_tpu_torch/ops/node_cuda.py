"""Node linearization of every running node (kernel K1, csrc/node.cu).

``calc_diff_running`` launches the CUDA kernel for CUDA tensors and runs
the plain PyTorch version, ``calc_diff_running_plain``, for CPU tensors.
There is no fallback: a CUDA call either launches or raises.
"""

from __future__ import annotations

import torch

from ..ocp import problem as P
from ..utils import spans
from . import _cuda

#: kernel launches since the last reset (the plain path does not count),
#: and those of them on an RK4 spec
LAUNCHES = 0
RK4_LAUNCHES = 0


def calc_diff_running_plain(spec: P.ProblemSpec, params: P.ProblemParams,
                            xs, us) -> P.NodeDerivatives:
    """``problem.node_calc_diff`` over the flattened B * T nodes."""
    B, T = us.shape[:2]
    flat = lambda a: a.reshape((B * T,) + a.shape[2:])
    view = P.map_params(flat, P.running_views(params.node, T))
    glob = P.map_params(
        lambda a: flat(a[:, None].expand((B, T) + a.shape[1:])), params.glob)
    d = P.node_calc_diff(spec, view, glob, flat(xs[:, :T]), flat(us))
    return P.map_params(lambda a: a.reshape((B, T) + a.shape[1:]), d)


@spans.spanned("k1")
def calc_diff_running(spec: P.ProblemSpec, params: P.ProblemParams,
                      xs, us) -> P.NodeDerivatives:
    """Derivatives of the running nodes: xs (B, T+1, nx), us (B, T, nu),
    batched params -> NodeDerivatives with leading (B, T)."""
    if xs.device.type == "cpu":
        return calc_diff_running_plain(spec, params, xs, us)
    global LAUNCHES, RK4_LAUNCHES
    _cuda.require_cuda(xs)
    B, T = us.shape[0], spec.T
    nx, nu, ndx = spec.model.nx, spec.nu, spec.state.ndx
    x = xs[:, :T].contiguous()
    _cuda.check_tensor(x, "xs", (B, T, nx), xs.dtype, xs.device)
    _cuda.check_tensor(us, "us", (B, T, nu), xs.dtype, xs.device)
    node_rows, glob_rows = _cuda.pack_params(spec, params, xs.dtype, xs.device)
    e = lambda *shape: torch.empty((B, T) + shape, dtype=xs.dtype,
                                   device=xs.device)
    out = P.NodeDerivatives(cost=e(), xnext=e(nx), Fx=e(ndx, ndx), Fu=e(ndx, nu),
                            Lx=e(ndx), Lu=e(nu), Lxx=e(ndx, ndx),
                            Lxu=e(ndx, nu), Luu=e(nu, nu))
    _cuda.call("eagle_node", xs.dtype, *_cuda.descriptor_args(spec, xs.device),
               B * T, T,
               *(a.data_ptr() for a in (x, us, node_rows, glob_rows) + out))
    LAUNCHES += 1
    RK4_LAUNCHES += spec.integrator == P.RK4
    return out
