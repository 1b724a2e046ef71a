"""The plain PyTorch versions of the port's three kernels, K1 (node
linearization), K2 (line-search rollouts) and K3 (Riccati backward pass),
under the names the solver calls (``calc_diff_running``, ``rollout``,
``backward``): the reference runs them on every device and launches no
kernel."""

from __future__ import annotations

import torch

from ..ocp import problem as P
from .smallmat import CholFactor


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


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


calc_diff_running = calc_diff_running_plain
rollout = rollout_plain


def backward(*args):
    """K3's signature without the Box-DDP gains."""
    return backward_plain(*args)
