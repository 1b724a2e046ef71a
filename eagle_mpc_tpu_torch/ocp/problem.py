"""The shooting OCP as (static spec, parameter tensors).

PyTorch counterpart of ``eagle_mpc_tpu.ocp.problem`` for free and
contact-constrained dynamics (3-D and 6-D contacts with per-node activity,
the friction cone on their forces), the symplectic-Euler and RK4
integrators and STATE/CONTROL/operational-frame cost slots:

- ``ProblemSpec``: static structure (robot model, cost slots, horizon, dt);
- ``ProblemParams``: tensors a controller changes at run time (per-node
  weights, activity, references; global activation parameters; x0).

``from_trajectory`` builds both from a mission (the stages' costs as the
union of slots, per-node weights and masks; the stages' contacts as the
union of contact slots, per-node activity and references), unbatched.
Any contact anywhere makes every node run the constrained dynamics; an
inactive contact reduces them exactly to free dynamics.

A batched ``ProblemParams`` carries a leading scenario axis B on every
leaf: ``x0`` (B, nx), node leaves (B, T+1, ...), global leaves (B, ...)
and ``squash_smooth`` (B,). Node functions accept any leading shape on
``x``/``s`` with parameters that broadcast against it; a global leaf of
shape prefix + (d,) pairs with ``squash_smooth`` of shape prefix.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..config import specs as cspecs
from ..dynamics import lie, rbd
from ..dynamics.model import RobotModel
from ..dynamics.state import State
from ..utils import spans
from . import actuation as act
from . import costs as C

EULER = "euler"
RK4 = "rk4"

_INTEGRATOR_MAP = {
    cspecs.INTEGRATOR_EULER: EULER,
    cspecs.INTEGRATOR_RK4: RK4,
    EULER: EULER,
    RK4: RK4,
}

_ACT_MAP = {
    cspecs.ACT_QUAD: C.QUAD,
    cspecs.ACT_WEIGHTED_QUAD: C.WQUAD,
    cspecs.ACT_QUAD_BARRIER: C.QBARRIER,
    cspecs.ACT_WEIGHTED_QUAD_BARRIER: C.WQBARRIER,
}

_KIND_MAP = {
    cspecs.COST_STATE: C.STATE,
    cspecs.COST_CONTROL: C.CONTROL,
    cspecs.COST_FRAME_PLACEMENT: C.FRAME_PLACEMENT,
    cspecs.COST_FRAME_TRANSLATION: C.FRAME_TRANSLATION,
    cspecs.COST_FRAME_ROTATION: C.FRAME_ROTATION,
    cspecs.COST_FRAME_VELOCITY: C.FRAME_VELOCITY,
    cspecs.COST_FRICTION_CONE: C.FRICTION_CONE,
}

BARRIER_SLOT = "barrier"


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------

class NodeParams(NamedTuple):
    """Per-node cost and contact parameters; node axis of length T+1 (index
    T is the terminal node). A spec without contacts has
    ``contact_active`` None and no ``contact_refs``."""

    weight: torch.Tensor               # (T+1, K)
    active: torch.Tensor               # (T+1, K) float mask
    refs: Tuple[torch.Tensor, ...]     # per slot: (T+1, ref_dim)
    contact_active: Optional[torch.Tensor] = None   # (T+1, NC) float mask
    contact_refs: Tuple[torch.Tensor, ...] = ()     # per contact: (T+1, 3|7)


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
    contact_active: Optional[torch.Tensor] = None
    contact_refs: Tuple[torch.Tensor, ...] = ()


def map_params(fn, params):
    """Apply ``fn`` to every tensor leaf of a parameter container (None
    stays None)."""
    if params is None:
        return None
    if isinstance(params, torch.Tensor):
        return fn(params)
    leaves = (map_params(fn, p) for p in params)
    return type(params)(*leaves) if hasattr(params, "_fields") else tuple(leaves)


def expand_params(params: ProblemParams, B: int) -> ProblemParams:
    """Unbatched params -> batched params (a leading B on every leaf)."""
    return map_params(lambda a: a.expand((B,) + a.shape), params)


def node_views(node: NodeParams, index) -> NodeView:
    """``node`` indexed by ``index`` on every leaf (batched node params
    (B, T+1, ...): ``index`` selects along the node axis, e.g.
    ``(slice(None), t)``)."""
    return NodeView(*map_params(lambda a: a[index], node))


def running_views(node: NodeParams, T: int) -> NodeView:
    """Views of the T running nodes of batched node params: (B, T, ...)."""
    return node_views(node, (slice(None), slice(None, T)))


def terminal_view(node: NodeParams, T: int) -> NodeView:
    return node_views(node, (slice(None), T))


def glob_over_nodes(glob: GlobalParams) -> GlobalParams:
    """Batched global params (B, ...) -> (B, 1, ...), broadcasting over a
    node axis."""
    return map_params(lambda a: a.unsqueeze(1), glob)


# ---------------------------------------------------------------------------
# Problem spec
# ---------------------------------------------------------------------------

class ContactSlot(NamedTuple):
    """Static description of one contact channel (Crocoddyl's
    ContactModel3D / 6D as the reference's factory builds them; same fields
    as the reference package's ``ContactSlot``). Per-node activity and the
    reference position (3-D) or pose (6-D: position + quaternion) are
    parameters; the Baumgarte gains (kp, kd) are static."""

    name: str
    frame_id: int
    dim: int                 # 3 (point) or 6 (placement)
    ref_dim: int             # 3 or 7
    gains: Tuple[float, float] = (0.0, 0.0)


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
    contacts: Tuple[ContactSlot, ...] = ()

    @property
    def state(self) -> State:
        return State(self.model.nq, self.model.nv)

    @property
    def nc_rows(self) -> int:
        return sum(c.dim for c in self.contacts)


def check_scope(spec: ProblemSpec) -> None:
    """Raise for a spec outside what this package evaluates."""
    if spec.integrator not in (EULER, RK4):
        raise NotImplementedError(f"integrator {spec.integrator!r}")
    for c in spec.contacts:
        if not isinstance(c, ContactSlot) or c.dim not in (3, 6):
            raise NotImplementedError(f"contact {c!r}: not a 3-D or 6-D "
                                      "ContactSlot")
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


def _contact_rows(spec: ProblemSpec, view: NodeView, x):
    """Stacked constraint rows of every contact at x: the Jacobian
    (..., nc, nv), the drift and Baumgarte terms a0 (..., nc) and each
    row's activity (..., nc).

    3-D contact: the LOCAL point acceleration (Crocoddyl's ContactModel3D:
    the linear rows plus w x v_lin), Baumgarte on the position error in the
    local frame and on the linear velocity. 6-D: the full LOCAL spatial
    acceleration, Baumgarte on the SE(3) log of the pose error and on the
    twist."""
    nq = spec.model.nq
    q, v = x[..., :nq], x[..., nq:]
    Js, a0s, acts = [], [], []
    for ci, c in enumerate(spec.contacts):
        m, f = spec.model, c.frame_id
        J6 = rbd.frame_jacobian_local(m, q, f)
        drift = rbd.frame_accel_drift(m, q, v, f)
        vf = rbd.frame_velocity(m, q, v, f)
        p, R = rbd.frame_placement(m, q, f)
        ref = view.contact_refs[ci]
        kp, kd = c.gains
        if c.dim == 3:
            a0 = (drift[..., :3] + lie.cross(vf[..., 3:], vf[..., :3])
                  + kp * lie.matvec(R.transpose(-1, -2), p - ref)
                  + kd * vf[..., :3])
            Js.append(J6[..., :3, :])
        else:
            RrefT = lie.quat_to_rot(ref[..., 3:7]).transpose(-1, -2)
            err = lie.log6(lie.matvec(RrefT, p - ref[..., :3]),
                           lie.rot_to_quat(RrefT @ R))
            a0 = drift + kp * err + kd * vf
            Js.append(J6)
        a0s.append(a0)
        ca = view.contact_active[..., ci:ci + 1]
        acts.append(ca.expand(ca.shape[:-1] + (c.dim,)))
    return (torch.cat(Js, dim=-2), torch.cat(a0s, dim=-1),
            torch.cat(acts, dim=-1))


def _split_forces(spec: ProblemSpec, lam):
    """Per-contact LOCAL forces from the stacked multipliers."""
    forces, off = [], 0
    for c in spec.contacts:
        forces.append(lam[..., off:off + c.dim])
        off += c.dim
    return tuple(forces)


#: evaluations of the plain node dynamics (``_dam``) on tensors on the card
#: since the last reset: a solve on the card makes none, K1 and K2 take them
PLAIN_ON_CARD = 0


def _dam(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x, s):
    """Continuous dynamics, free or contact-constrained: (a, u_squash,
    per-contact forces)."""
    global PLAIN_ON_CARD
    PLAIN_ON_CARD += x.device.type != "cpu"
    u = squash(spec, glob, s)
    tau = act.actuation_tau(tau_f_tensor(spec, x.device, x.dtype), u)
    nq = spec.model.nq
    q, v = x[..., :nq], x[..., nq:]
    if not spec.contacts:
        return rbd.fwd_dynamics(spec.model, q, v, tau), u, ()
    J, a0, active = _contact_rows(spec, view, x)
    a, lam = rbd.contact_fwd_dynamics(spec.model, q, v, tau, J, a0, active)
    return a, u, _split_forces(spec, lam)


@functools.lru_cache(maxsize=64)
def cone_tensor(slot: C.CostSlot, device, dtype):
    return torch.as_tensor(slot.cone_A, dtype=dtype, device=device)


def _point_residuals(spec: ProblemSpec, view: NodeView, x, s, terminal: bool,
                     forces=()):
    """Residual of every slot; control slots are zero at the terminal node.
    The frame slots share one forward-kinematics cache built at x. A
    friction-cone slot is A R f (f the contact's LOCAL force, R its frame's
    world rotation), zero at the terminal node, without forces and for a
    cone without a contact."""
    st = spec.state
    cache = C.build_fk_cache(spec.model, spec.slots, x[..., :st.nq],
                             x[..., st.nq:])
    zeros = lambda n: torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype,
                                  device=x.device)
    rs = []
    for k, slot in enumerate(spec.slots):
        if slot.kind == C.FRICTION_CONE:
            if not forces or slot.contact_id < 0 or terminal:
                rs.append(zeros(slot.nr))
                continue
            _, R = rbd.frame_placement(
                spec.model, x[..., :st.nq],
                spec.contacts[slot.contact_id].frame_id)
            f_w = lie.matvec(R, forces[slot.contact_id][..., :3])
            rs.append(lie.matvec(cone_tensor(slot, x.device, x.dtype), f_w))
        elif terminal and slot.kind == C.CONTROL:
            rs.append(zeros(slot.nr))
        else:
            rs.append(C.residual(spec.model, st, slot, view.refs[k], cache,
                                 x, s))
    return rs


def _point_cost(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x, s,
                terminal: bool, forces=()):
    rs = _point_residuals(spec, view, x, s, terminal, forces)
    total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k, slot in enumerate(spec.slots):
        a, _, _ = C.activation(slot.activation, rs[k], glob.act_w[k],
                               glob.lb[k], glob.ub[k])
        total = total + view.weight[..., k] * view.active[..., k] * a
    return total


def _stage_points(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x, s):
    """Evaluation points and quadrature coefficients of the integrator:
    ([(coeff, x_i, forces_i)], xnext, u_squash), the coefficients summing
    to dt. Euler is the reference's symplectic Euler (dq = v dt + a dt^2,
    dv = a dt); RK4 is crocoddyl's manifold RK4 with the cost quadrature
    dt/6 (l0 + 2 l1 + 2 l2 + l3), each stage point with its contact forces."""
    st = spec.state
    dt = spec.dt
    v = x[..., st.nq:]
    a0, u_sq, f0 = _dam(spec, view, glob, x, s)
    if spec.integrator == EULER:
        vnext = v + a0 * dt
        dx = torch.cat([vnext * dt, a0 * dt], dim=-1)
        return [(dt, x, f0)], st.integrate(x, dx), u_sq

    def k(xi, ai):
        return torch.cat([xi[..., st.nq:], ai], dim=-1)

    k0 = k(x, a0)
    y1 = st.integrate(x, k0 * (dt / 2))
    a1, _, f1 = _dam(spec, view, glob, y1, s)
    k1 = k(y1, a1)
    y2 = st.integrate(x, k1 * (dt / 2))
    a2, _, f2 = _dam(spec, view, glob, y2, s)
    k2 = k(y2, a2)
    y3 = st.integrate(x, k2 * dt)
    a3, _, f3 = _dam(spec, view, glob, y3, s)
    k3 = k(y3, a3)
    dx = (k0 + 2 * k1 + 2 * k2 + k3) * (dt / 6)
    pts = [(dt / 6, x, f0), (dt / 3, y1, f1), (dt / 3, y2, f2), (dt / 6, y3, f3)]
    return pts, st.integrate(x, dx), u_sq


def node_calc(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x, s):
    """Running node: (xnext, discrete cost, u_squash); the cost is the
    integrator's quadrature of l over its stage points (Euler: dt l(x, s))."""
    pts, xnext, u_sq = _stage_points(spec, view, glob, x, s)
    cost = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for coeff, xi, fi in pts:
        cost = cost + coeff * _point_cost(spec, view, glob, xi, s, False, fi)
    return xnext, cost, u_sq


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
    rows; J_res (..., n_res, n), val_res (..., n_res) (n_res may be 0)."""
    cost = torch.zeros(val_res.shape[:-1], dtype=J_res.dtype,
                       device=J_res.device)
    gAr, gArr = [val_res[..., :0]], [val_res[..., :0]]
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
    dynamics Jacobians and every residual Jacobian at every stage point;
    cost derivatives are Gauss-Newton over the stacked rows, each stage's
    weighted by its quadrature coefficient."""
    st = spec.state
    ndx = st.ndx
    pts0, xnext0, _ = _stage_points(spec, view, glob, x, s)

    def fun(z):
        xx = st.integrate(x, z[..., :ndx])
        ss = s + z[..., ndx:]
        pts, xnext, _ = _stage_points(spec, view, glob, xx, ss)
        outs = [st.diff(xnext0, xnext)]
        for _, xi, fi in pts:
            outs += _point_residuals(spec, view, xi, ss, False, fi)
        return torch.cat(outs, dim=-1)

    z0 = torch.zeros(x.shape[:-1] + (ndx + spec.nu,), dtype=x.dtype,
                     device=x.device)
    val0, J = _jacobian(fun, z0)
    n_res = sum(slot.nr for slot in spec.slots)
    rows = [slice(ndx + i * n_res, ndx + (i + 1) * n_res)
            for i in range(len(pts0))]
    cost, g, H = (sum(terms) for terms in zip(*(
        _gauss_newton(spec, J[..., r, :], val0[..., r], view, glob, coeff)
        for r, (coeff, _, _) in zip(rows, pts0))))
    return NodeDerivatives(
        cost=cost, xnext=xnext0, Fx=J[..., :ndx, :ndx], Fu=J[..., :ndx, ndx:],
        Lx=g[..., :ndx], Lu=g[..., ndx:], Lxx=H[..., :ndx, :ndx],
        Lxu=H[..., :ndx, ndx:], Luu=H[..., ndx:, ndx:])


@spans.spanned("ocp.terminal")
def terminal_calc_diff(spec: ProblemSpec, view: NodeView, glob: GlobalParams, x):
    """(cost, Lx, Lxx) of terminal nodes, batched like node_calc_diff."""
    st = spec.state
    s0 = torch.zeros(x.shape[:-1] + (spec.nu,), dtype=x.dtype, device=x.device)

    def fun(dx):
        xx = st.integrate(x, dx)
        return torch.cat([xx[..., :0]] + _point_residuals(spec, view, xx, s0,
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
    """Total cost (B,) of candidates without the dynamics rollout: under
    Euler the running cost is dt * l(x_t, u_t). A contact or RK4 spec
    evaluates the whole node instead, as the reference does: the friction
    cone needs the forces of the constrained dynamics, RK4's quadrature its
    stage points; on the card K1 does it."""
    views = running_views(params.node, spec.T)
    glob = glob_over_nodes(params.glob)
    cT = terminal_calc(spec, terminal_view(params.node, spec.T), params.glob,
                       xs[:, spec.T])
    whole_node = bool(spec.contacts) or spec.integrator != EULER
    if whole_node and xs.device.type != "cpu":
        from ..ops import node_cuda

        return node_cuda.calc_diff_running(spec, params, xs, us).cost.sum(1) + cT
    if whole_node:
        return node_calc(spec, views, glob, xs[:, :spec.T], us)[1].sum(1) + cT
    costs = _point_cost(spec, views, glob, xs[:, :spec.T], us, False)
    return spec.dt * costs.sum(dim=1) + cT


def contact_violation(spec: ProblemSpec, params: ProblemParams, xs, us):
    """max |J a + a0| over each running node's active contact rows (B, T),
    0 where none is active: how far the constrained dynamics at (xs, us)
    leave the contacts' acceleration constraint (batched params, as the
    solve used them). A check, in the plain version: after a solve on the
    card, call it on host copies."""
    views = running_views(params.node, spec.T)
    x = xs[:, :spec.T]
    J, a0, active = _contact_rows(spec, views, x)
    a = _dam(spec, views, glob_over_nodes(params.glob), x, us)[0]
    return (active * (lie.matvec(J, a) + a0)).abs().amax(dim=-1)


def squashed_controls(spec: ProblemSpec, params: ProblemParams, us):
    """us (B, T, nu) -> squashed controls (what the plant consumes)."""
    return squash(spec, glob_over_nodes(params.glob), us)


# ---------------------------------------------------------------------------
# Problems from mission files
# ---------------------------------------------------------------------------

def _slot_key(cost: cspecs.CostSpec):
    """Two stage costs share a slot iff their static signature matches; all
    per-node data (weight, activity, reference) lives in params."""
    act_w = cost.act_weights.tobytes() if cost.act_weights is not None else b""
    lb = cost.lower_bound.tobytes() if cost.lower_bound is not None else b""
    ub = cost.upper_bound.tobytes() if cost.upper_bound is not None else b""
    cone = (cost.n_surf.tobytes(), cost.mu) if cost.n_surf is not None else None
    return (cost.type, cost.activation, cost.nr, cost.frame_id, act_w, lb, ub, cone)


def _encode_ref(cost: cspecs.CostSpec, nx: int, nu: int) -> np.ndarray:
    """A cost's reference as its slot stores it."""
    kind = _KIND_MAP[cost.type]
    if kind in (C.STATE, C.CONTROL):
        return np.asarray(cost.reference, dtype=np.float64)
    if kind == C.FRAME_PLACEMENT:
        return np.concatenate([cost.position, cost.orientation])
    if kind == C.FRAME_TRANSLATION:
        return np.asarray(cost.position, dtype=np.float64)
    if kind == C.FRAME_ROTATION:
        return np.asarray(cost.orientation, dtype=np.float64)
    if kind == C.FRAME_VELOCITY:
        return np.concatenate([cost.linear, cost.angular])
    return np.zeros(0)


def _default_ref(slot: C.CostSlot, nx: int) -> np.ndarray:
    """The reference of a node where the slot's stage has no such cost."""
    if slot.kind == C.STATE:
        ref = np.zeros(nx)
        ref[6] = 1.0
        return ref
    if slot.kind in (C.FRAME_PLACEMENT, C.FRAME_ROTATION):
        ref = np.zeros(slot.ref_dim)
        ref[-1] = 1.0  # identity quaternion tail
        return ref
    return np.zeros(slot.ref_dim)


def stage_knots(stages, dt_ms: int) -> Tuple[np.ndarray, int]:
    """Running knots per stage and the terminal stage index, by the
    duration-0 rules of the reference's Trajectory::createProblem: a stage
    shorter than dt contributes 1 knot (and takes one from the next stage)
    unless it is last, in which case it only becomes the terminal node."""
    n = len(stages)
    knots = np.zeros(n, dtype=int)
    last_d0 = False
    for i, st in enumerate(stages):
        if st.duration // dt_ms == 0 and i + 1 < n:
            knots[i] = 1
            last_d0 = True
        else:
            knots[i] = st.duration // dt_ms - (1 if last_d0 else 0)
            last_d0 = False
    return knots, n - 1


def from_trajectory(traj: cspecs.TrajectorySpec, dt_ms: Optional[int] = None,
                    use_squash: Optional[bool] = None,
                    integrator: Optional[str] = None,
                    squash_smooth: float = 0.1, dtype=torch.float64,
                    device=None) -> Tuple[ProblemSpec, ProblemParams]:
    """Mission spec -> (spec, unbatched params) on ``device`` (default: the
    card; the caller asks for the CPU explicitly). The stages' differing
    cost sets become the union of slots with per-node weights and masks;
    the last stage's model is the terminal node. ``expand_params`` batches
    the params."""
    if dt_ms is None:
        dt_ms = traj.problem_params.dt
    if use_squash is None:
        use_squash = traj.problem_params.use_squash
    if integrator is None:
        integrator = traj.problem_params.integrator
    if not integrator:
        raise ValueError("Problem parameters not specified in the YAML file. "
                         "Pass dt/use_squash/integrator explicitly.")
    device = torch.device("cuda") if device is None else device
    integ = _INTEGRATOR_MAP[integrator]
    model = traj.model
    nx, nu = model.nx, traj.nu

    # the contact union: one slot per (frame, dimension)
    contact_keys = {}
    contact_slots: list = []
    stage_contact_idx = []   # per stage: [(contact index, contact)]
    for st in traj.stages:
        entries = []
        for con in st.contacts:
            dim = 6 if con.type == cspecs.CONTACT_6D else 3
            key = (con.frame_id, dim)
            if key not in contact_keys:
                contact_keys[key] = len(contact_slots)
                contact_slots.append(ContactSlot(
                    name=con.name, frame_id=con.frame_id, dim=dim,
                    ref_dim=7 if dim == 6 else 3,
                    gains=tuple(float(g) for g in con.gains)))
            entries.append((contact_keys[key], con))
        stage_contact_idx.append(entries)

    def cone_contact_id(frame_id: int) -> int:
        """The first contact slot on a cone's frame, or -1."""
        for i, cs in enumerate(contact_slots):
            if cs.frame_id == frame_id:
                return i
        return -1

    # the slot union: one slot per static signature
    slot_keys = {}
    slots: list = []
    slot_specs: list = []
    stage_slot_idx = []   # per stage: [(slot index, cost)]
    for st in traj.stages:
        entries = []
        for cost in st.costs:
            key = _slot_key(cost)
            if key not in slot_keys:
                slot_keys[key] = len(slots)
                kind = _KIND_MAP[cost.type]
                ref_dims = {C.STATE: nx, C.CONTROL: nu, C.FRICTION_CONE: 0}
                cone = None
                if cost.n_surf is not None:
                    cone = tuple(map(tuple, C.friction_cone_matrix(
                        cost.n_surf, cost.mu)))
                slots.append(C.CostSlot(
                    name=f"{st.name}/{cost.name}", kind=kind,
                    activation=_ACT_MAP[cost.activation], nr=cost.nr,
                    ref_dim=ref_dims.get(kind, C.REF_DIMS.get(kind, cost.nr)),
                    frame_id=cost.frame_id,
                    contact_id=cone_contact_id(cost.frame_id)
                    if kind == C.FRICTION_CONE else -1,
                    cone_A=cone))
                slot_specs.append(cost)
            entries.append((slot_keys[key], cost))
        stage_slot_idx.append(entries)

    if use_squash:
        slots.append(C.CostSlot(name=BARRIER_SLOT, kind=C.CONTROL,
                                activation=C.WQBARRIER, nr=nu, ref_dim=nu))
        slot_specs.append(None)

    knots, term_stage = stage_knots(traj.stages, dt_ms)
    T = int(knots.sum())
    if T <= 0:
        raise ValueError("Trajectory has no running nodes at this dt")

    spec = ProblemSpec(
        model=model, nu=nu, tau_f=tuple(map(tuple, traj.platform.tau_f)),
        slots=tuple(slots), integrator=integ, T=T, dt=dt_ms / 1000.0,
        use_squash=use_squash, contacts=tuple(contact_slots))

    K = len(slots)
    weight = np.zeros((T + 1, K))
    active = np.zeros((T + 1, K))
    refs = [np.tile(_default_ref(s, nx), (T + 1, 1)) for s in slots]
    node_stage = np.zeros(T + 1, dtype=int)
    t = 0
    for si in range(len(traj.stages)):
        for _ in range(knots[si]):
            node_stage[t] = si
            t += 1
    node_stage[T] = term_stage
    NC = len(contact_slots)
    contact_active = np.zeros((T + 1, NC))
    contact_refs = []
    for cs in contact_slots:
        r = np.zeros(cs.ref_dim)
        if cs.ref_dim == 7:
            r[6] = 1.0   # the identity quaternion
        contact_refs.append(np.tile(r, (T + 1, 1)))
    for t in range(T + 1):
        for k, cost in stage_slot_idx[node_stage[t]]:
            weight[t, k] = cost.weight
            active[t, k] = 1.0 if cost.active else 0.0
            refs[k][t] = _encode_ref(cost, nx, nu)
        for c, con in stage_contact_idx[node_stage[t]]:
            contact_active[t, c] = 1.0
            contact_refs[c][t] = (
                np.concatenate([con.position, con.orientation])
                if contact_slots[c].ref_dim == 7 else con.position)

    s_lb = np.asarray(traj.platform.u_lb, dtype=np.float64)
    s_ub = np.asarray(traj.platform.u_ub, dtype=np.float64)
    act_w, lbs, ubs = [], [], []
    for k, (slot, cost) in enumerate(zip(slots, slot_specs)):
        if slot.name == BARRIER_SLOT:
            weight[:T, k] = 1e-3     # the reference's barrier weight
            active[:T, k] = 1.0
            act_w.append(act.barrier_quad_weights(s_lb, s_ub, squash_smooth))
            lbs.append(s_lb.copy())
            ubs.append(s_ub.copy())
            continue
        nr = slot.nr
        act_w.append(cost.act_weights if cost.act_weights is not None
                     else np.ones(nr))
        lbs.append(cost.lower_bound if cost.lower_bound is not None
                   else np.full(nr, -np.inf))
        ubs.append(cost.upper_bound if cost.upper_bound is not None
                   else np.full(nr, np.inf))

    cvt = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                    dtype=dtype, device=device)
    params = ProblemParams(
        x0=cvt(traj.initial_state),
        node=NodeParams(weight=cvt(weight), active=cvt(active),
                        refs=tuple(cvt(r) for r in refs),
                        contact_active=cvt(contact_active) if NC else None,
                        contact_refs=tuple(cvt(r) for r in contact_refs)),
        glob=GlobalParams(
            act_w=tuple(cvt(a) for a in act_w), lb=tuple(cvt(a) for a in lbs),
            ub=tuple(cvt(a) for a in ubs), squash_smooth=cvt(squash_smooth),
            s_lb=cvt(s_lb), s_ub=cvt(s_ub)))
    return spec, params


def contact_6d(traj: cspecs.TrajectorySpec) -> cspecs.TrajectorySpec:
    """``traj`` with every contact switched to a 6-D one that holds its
    frame's initial pose: the reference orientation is the frame's at the
    initial state, the position stays the mission's (a test variant of a
    3-D contact mission)."""
    q0 = torch.as_tensor(np.asarray(traj.initial_state)[:traj.model.nq])

    def six(con):
        R = rbd.frame_placement(traj.model, q0, con.frame_id)[1]
        return dataclasses.replace(con, type="ContactModel6D",
                                   orientation=lie.rot_to_quat(R).numpy())
    return dataclasses.replace(traj, stages=tuple(
        dataclasses.replace(st, contacts=tuple(six(c) for c in st.contacts))
        for st in traj.stages))
