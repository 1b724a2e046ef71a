"""Line-search rollouts for every (problem, alpha) lane (kernel K2,
csrc/rollout.cu).

``rollout`` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version, ``rollout_plain``, for CPU tensors. There is no
fallback: a CUDA call either launches or raises.
"""

from __future__ import annotations

import torch

from ..ocp import problem as P
from ..utils import spans
from . import _cuda

#: kernel launches since the last reset (the plain path does not count),
#: those of them with the box clip and those on an RK4 spec
LAUNCHES = 0
BOX_LAUNCHES = 0
RK4_LAUNCHES = 0


def rollout_plain(spec: P.ProblemSpec, params: P.ProblemParams, xs, us, k, K,
                  fs, alphas, keep, box: bool = False):
    """FDDP forward pass of the running nodes for every alpha at once.

    xs (B, T+1, nx) current states, us/k (B, T, nu), K (B, T, nu, ndx),
    fs (B, T+1, ndx) gaps, alphas (A,), keep (B, A) gap-contraction mask;
    ``box`` clips the feedback law's controls to ``s_lb``/``s_ub`` (the
    Box-DDP rollout). Returns xs_try (B, A, T, nx), us_try (B, A, T, nu), per-node costs
    cs (B, A, T) and the state after the last node xn (B, A, nx)."""
    st = spec.state
    B, A = keep.shape
    node = params.node
    glob = P.glob_over_nodes(params.glob)
    al = alphas[None, :, None]
    x = params.x0[:, None].expand(B, A, params.x0.shape[-1])
    xs_try, us_try, cs = [], [], []
    for t in range(spec.T):
        x_gap = st.integrate(x, fs[:, None, t] * (al - 1.0))
        x = torch.where(keep[..., None], x_gap, x)
        dx = st.diff(xs[:, None, t], x)
        u = us[:, None, t] - al * k[:, None, t] - (K[:, None, t] @ dx[..., None])[..., 0]
        if box:
            u = torch.minimum(torch.maximum(u, glob.s_lb), glob.s_ub)
        view = P.node_views(node, (slice(None), None, t))
        xn, c, _ = P.node_calc(spec, view, glob, x, u)
        xs_try.append(x)
        us_try.append(u)
        cs.append(c)
        x = xn
    return (torch.stack(xs_try, dim=2), torch.stack(us_try, dim=2),
            torch.stack(cs, dim=2), x)


@spans.spanned("k2")
def rollout(spec: P.ProblemSpec, params: P.ProblemParams, xs, us, k, K, fs,
            alphas, keep, box: bool = False):
    """Same signature and result as :func:`rollout_plain`."""
    if xs.device.type == "cpu":
        return rollout_plain(spec, params, xs, us, k, K, fs, alphas, keep, box)
    global LAUNCHES, BOX_LAUNCHES, RK4_LAUNCHES
    _cuda.require_cuda(xs)
    B, A = keep.shape
    T, nx, nu, ndx = spec.T, spec.model.nx, spec.nu, spec.state.ndx
    dt, dev = xs.dtype, xs.device
    node_rows, glob_rows = _cuda.pack_params(spec, params, dt, dev)
    ins = [(xs.contiguous(), "xs", (B, T + 1, nx)), (us.contiguous(), "us", (B, T, nu)),
           (k.contiguous(), "k", (B, T, nu)), (K.contiguous(), "K", (B, T, nu, ndx)),
           (fs.contiguous(), "fs", (B, T + 1, ndx)),
           (params.x0.contiguous(), "x0", (B, nx)),
           (alphas.contiguous(), "alphas", (A,))]
    for t, name, shape in ins:
        _cuda.check_tensor(t, name, shape, dt, dev)
    keep8 = keep.to(torch.uint8).contiguous()
    _cuda.check_tensor(keep8, "keep", (B, A), torch.uint8, dev)
    e = lambda *shape: torch.empty((B, A) + shape, dtype=dt, device=dev)
    out = (e(T, nx), e(T, nu), e(T), e(nx))
    _cuda.call("eagle_rollout", dt, *_cuda.descriptor_args(spec, dev), B, A, T,
               int(box),
               *(a.data_ptr() for a in [t for t, _, _ in ins]
                 + [keep8, node_rows, glob_rows, *out]))
    LAUNCHES += 1
    BOX_LAUNCHES += int(box)
    RK4_LAUNCHES += spec.integrator == P.RK4
    return out
