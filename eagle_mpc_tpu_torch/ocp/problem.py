"""The shooting OCP as (static spec, parameter tensors).

PyTorch counterpart of ``eagle_mpc_tpu.ocp.problem`` for free dynamics,
the symplectic-Euler integrator and STATE/CONTROL/operational-frame cost
slots:

- ``ProblemSpec``: static structure (robot model, cost slots, horizon, dt);
- ``ProblemParams``: tensors a controller changes at run time (per-node
  weights, activity, references; global activation parameters; x0).

A batched ``ProblemParams`` carries a leading scenario axis B on every
leaf: ``x0`` (B, nx), node leaves (B, T+1, ...), global leaves (B, ...)
and ``squash_smooth`` (B,). Node functions accept any leading shape on
``x``/``s`` with parameters that broadcast against it; a global leaf of
shape prefix + (d,) pairs with ``squash_smooth`` of shape prefix.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from ..dynamics import rbd
from ..dynamics.model import RobotModel
from ..dynamics.state import State
from . import actuation as act
from . import costs as C

EULER = "euler"
RK4 = "rk4"

BARRIER_SLOT = "barrier"


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------

class NodeParams(NamedTuple):
    """Per-node cost parameters; node axis of length T+1 (index T is the
    terminal node)."""

    weight: torch.Tensor               # (T+1, K)
    active: torch.Tensor               # (T+1, K) float mask
    refs: Tuple[torch.Tensor, ...]     # per slot: (T+1, ref_dim)


class GlobalParams(NamedTuple):
    act_w: Tuple[torch.Tensor, ...]    # per slot: (nr,)
    lb: Tuple[torch.Tensor, ...]       # per slot: (nr,)
    ub: Tuple[torch.Tensor, ...]       # per slot: (nr,)
    squash_smooth: torch.Tensor        # ()
    s_lb: torch.Tensor                 # (nu,)
    s_ub: torch.Tensor                 # (nu,)


class ProblemParams(NamedTuple):
    x0: torch.Tensor
    node: NodeParams
    glob: GlobalParams


class NodeView(NamedTuple):
    """NodeParams at one node (or a batch of nodes)."""

    weight: torch.Tensor
    active: torch.Tensor
    refs: Tuple[torch.Tensor, ...]


def map_params(fn, params):
    """Apply ``fn`` to every tensor leaf of a parameter container."""
    if isinstance(params, torch.Tensor):
        return fn(params)
    leaves = (map_params(fn, p) for p in params)
    return type(params)(*leaves) if hasattr(params, "_fields") else tuple(leaves)


def expand_params(params: ProblemParams, B: int) -> ProblemParams:
    """Unbatched params -> batched params (a leading B on every leaf)."""
    return map_params(lambda a: a.expand((B,) + a.shape), params)


def running_views(node: NodeParams, T: int) -> NodeView:
    """Views of the T running nodes of batched node params: (B, T, ...)."""
    return NodeView(node.weight[:, :T], node.active[:, :T],
                    tuple(r[:, :T] for r in node.refs))


def terminal_view(node: NodeParams, T: int) -> NodeView:
    return NodeView(node.weight[:, T], node.active[:, T],
                    tuple(r[:, T] for r in node.refs))


def glob_over_nodes(glob: GlobalParams) -> GlobalParams:
    """Batched global params (B, ...) -> (B, 1, ...), broadcasting over a
    node axis."""
    return map_params(lambda a: a.unsqueeze(1), glob)


# ---------------------------------------------------------------------------
# Problem spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    model: RobotModel
    nu: int
    tau_f: Tuple[Tuple[float, ...], ...]     # (6, n_rotors)
    slots: Tuple[C.CostSlot, ...]
    integrator: str
    T: int
    dt: float                                 # seconds
    use_squash: bool
    contacts: tuple = ()

    @property
    def state(self) -> State:
        return State(self.model.nq, self.model.nv)


def check_scope(spec: ProblemSpec) -> None:
    """Raise for a spec outside what this package evaluates."""
    if spec.integrator != EULER:
        raise NotImplementedError("only the Euler integrator is ported")
    if spec.contacts:
        raise NotImplementedError("contact dynamics are not ported yet")
    if not spec.slots:
        raise NotImplementedError("a spec needs at least one cost slot")
    for s in spec.slots:
        if s.kind not in C.SUPPORTED_KINDS or s.activation not in C.ACTIVATIONS:
            raise NotImplementedError(f"cost slot {s.name!r} ({s.kind}, "
                                      f"{s.activation}) is not ported yet")


class NodeDerivatives(NamedTuple):
    cost: torch.Tensor
    xnext: torch.Tensor
    Fx: torch.Tensor
    Fu: torch.Tensor
    Lx: torch.Tensor
    Lu: torch.Tensor
    Lxx: torch.Tensor
    Lxu: torch.Tensor      # (ndx, nu)
    Luu: torch.Tensor


@functools.lru_cache(maxsize=64)
def tau_f_tensor(spec: ProblemSpec, device, dtype):
    return torch.as_tensor(spec.tau_f, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Dynamics + cost evaluation
# ---------------------------------------------------------------------------

def squash(spec: ProblemSpec, glob: GlobalParams, s):
    if not spec.use_squash:
        return s
    return act.smooth_sat(s, glob.s_lb, glob.s_ub,
                          glob.squash_smooth.unsqueeze(-1))


def _dam(spec: ProblemSpec, glob: GlobalParams, x, s):
    """Continuous free dynamics: (a, u_squash)."""
    u = squash(spec, glob, s)
    tau = act.actuation_tau(tau_f_tensor(spec, x.device, x.dtype), u)
    nq = spec.model.nq
    return rbd.fwd_dynamics(spec.model, x[..., :nq], x[..., nq:], tau), u


def _point_residuals(spec: ProblemSpec, view: NodeView, x, s, terminal: bool):
    """Residual of every slot; control slots are zero at the terminal node.
    The frame slots share one forward-kinematics cache built at x."""
    st = spec.state
    cache = C.build_fk_cache(spec.model, spec.slots, x[..., :st.nq],
                             x[..., st.nq:])
    rs = []
    for k, slot in enumerate(spec.slots):
        if terminal and slot.kind == C.CONTROL:
            rs.append(torch.zeros(x.shape[:-1] + (slot.nr,), dtype=x.dtype,
                                  device=x.device))
        else:
            rs.append(C.residual(spec.model, st, slot, view.refs[k], cache,
                                 x, s))
    return rs


def _point_cost(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x, s,
                terminal: bool):
    rs = _point_residuals(spec, view, x, s, terminal)
    total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k, slot in enumerate(spec.slots):
        a, _, _ = C.activation(slot.activation, rs[k], glob.act_w[k],
                               glob.lb[k], glob.ub[k])
        total = total + view.weight[..., k] * view.active[..., k] * a
    return total


def _euler_step(spec: ProblemSpec, glob: GlobalParams, x, s):
    """Symplectic Euler: dq = v dt + a dt^2, dv = a dt. Returns
    (xnext, u_squash)."""
    st = spec.state
    dt = spec.dt
    a, u_sq = _dam(spec, glob, x, s)
    vnext = x[..., st.nq:] + a * dt
    return st.integrate(x, torch.cat([vnext * dt, a * dt], dim=-1)), u_sq


def node_calc(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x, s):
    """Running node: (xnext, discrete cost dt * l(x, s), u_squash)."""
    xnext, u_sq = _euler_step(spec, glob, x, s)
    return xnext, spec.dt * _point_cost(spec, view, glob, x, s, False), u_sq


def terminal_calc(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x):
    """Terminal node cost (not scaled by dt)."""
    s = torch.zeros(x.shape[:-1] + (spec.nu,), dtype=x.dtype, device=x.device)
    return _point_cost(spec, view, glob, x, s, True)


def _jacobian(fun, z0):
    """(fun(z0), J) by forward mode: ``fun`` runs once on nz copies of z0
    stacked on a new leading axis, copy j carrying the tangent e_j (``fun``
    must broadcast its closed-over tensors against that axis). ``z0``
    (..., nz); J (..., n_out, nz)."""
    nz = z0.shape[-1]
    eye = torch.eye(nz, dtype=z0.dtype, device=z0.device)
    basis = eye.reshape((nz,) + (1,) * (z0.ndim - 1) + (nz,)).expand(
        (nz,) + z0.shape).contiguous()
    with fwAD.dual_level():
        out = fun(fwAD.make_dual(torch.zeros_like(basis) + z0, basis))
        val, tan = fwAD.unpack_dual(out)
    return val[0], tan.movedim(0, -1)


def _gauss_newton(spec, J_res, val_res, view, glob, coeff):
    """cost, g = J'(w Ar), H = J' diag(w Arr) J over the stacked residual
    rows; J_res (..., n_res, n), val_res (..., n_res)."""
    cost = torch.zeros(val_res.shape[:-1], dtype=J_res.dtype,
                       device=J_res.device)
    gAr, gArr = [], []
    off = 0
    for k, slot in enumerate(spec.slots):
        r = val_res[..., off:off + slot.nr]
        off += slot.nr
        a, Ar, Arr = C.activation(slot.activation, r, glob.act_w[k],
                                  glob.lb[k], glob.ub[k])
        wk = coeff * view.weight[..., k] * view.active[..., k]
        cost = cost + wk * a
        gAr.append(wk[..., None] * Ar)
        gArr.append(wk[..., None] * Arr)
    wAr, wArr = torch.cat(gAr, dim=-1), torch.cat(gArr, dim=-1)
    JT = J_res.transpose(-1, -2)
    return cost, (JT @ wAr[..., None])[..., 0], JT @ (wArr[..., None] * J_res)


def node_calc_diff(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x, s):
    """Derivatives of running nodes in the tangent space, batched over the
    leading dims of x (..., nx) / s (..., nu) with matching params. One
    forward-mode Jacobian over the ndx + nu tangent directions gives the
    dynamics Jacobians and every residual Jacobian; cost derivatives are
    Gauss-Newton."""
    st = spec.state
    ndx = st.ndx
    xnext0, _ = _euler_step(spec, glob, x, s)

    def fun(z):
        xx = st.integrate(x, z[..., :ndx])
        ss = s + z[..., ndx:]
        xnext, _ = _euler_step(spec, glob, xx, ss)
        return torch.cat([st.diff(xnext0, xnext)]
                         + _point_residuals(spec, view, xx, ss, False), dim=-1)

    z0 = torch.zeros(x.shape[:-1] + (ndx + spec.nu,), dtype=x.dtype,
                     device=x.device)
    val0, J = _jacobian(fun, z0)
    cost, g, H = _gauss_newton(spec, J[..., ndx:, :], val0[..., ndx:], view,
                               glob, spec.dt)
    return NodeDerivatives(
        cost=cost, xnext=xnext0, Fx=J[..., :ndx, :ndx], Fu=J[..., :ndx, ndx:],
        Lx=g[..., :ndx], Lu=g[..., ndx:], Lxx=H[..., :ndx, :ndx],
        Lxu=H[..., :ndx, ndx:], Luu=H[..., ndx:, ndx:])


def terminal_calc_diff(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x):
    """(cost, Lx, Lxx) of terminal nodes, batched like node_calc_diff."""
    st = spec.state
    s0 = torch.zeros(x.shape[:-1] + (spec.nu,), dtype=x.dtype, device=x.device)

    def fun(dx):
        return torch.cat(_point_residuals(spec, view, st.integrate(x, dx), s0,
                                          True), dim=-1)

    val0, J = _jacobian(fun, torch.zeros_like(x[..., :st.ndx]))
    return _gauss_newton(spec, J, val0, view, glob, 1.0)


# ---------------------------------------------------------------------------
# Horizon-level evaluation over a batch of problems
# ---------------------------------------------------------------------------

def calc_diff_all(spec: ProblemSpec, params: ProblemParams, xs, us):
    """Derivatives of every running node (B, T, ...) through the node
    linearization kernel's wrapper, and of the terminal node (B, ...).
    ``xs`` (B, T+1, nx), ``us`` (B, T, nu), ``params`` batched."""
    from ..ops import node_cuda

    derivs = node_cuda.calc_diff_running(spec, params, xs, us)
    term = terminal_calc_diff(spec, terminal_view(params.node, spec.T),
                              params.glob, xs[:, spec.T])
    return derivs, term


def total_cost(spec: ProblemSpec, params: ProblemParams, xs, us):
    """Total cost (B,) of candidates without the dynamics rollout (valid for
    Euler without contacts: the running cost is dt * l(x_t, u_t))."""
    costs = _point_cost(spec, running_views(params.node, spec.T),
                        glob_over_nodes(params.glob), xs[:, :spec.T], us, False)
    cT = terminal_calc(spec, terminal_view(params.node, spec.T), params.glob,
                       xs[:, spec.T])
    return spec.dt * costs.sum(dim=1) + cT


def squashed_controls(spec: ProblemSpec, params: ProblemParams, us):
    """us (B, T, nu) -> squashed controls (what the plant consumes)."""
    return squash(spec, glob_over_nodes(params.glob), us)
