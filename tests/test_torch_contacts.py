"""The PyTorch port's contact layer against the JAX package, float64 on the
CPU (the kernels' plain versions).

The JAX values come from tests/fixtures/torch_port_contacts.npz
(``tools/make_torch_port_fixtures.py contacts``; nothing is jit-compiled
here):

- ``rbd.frame_jacobian_local``, ``frame_accel_drift``, ``frame_velocity``
  and ``contact_fwd_dynamics`` (3-D, 6-D, 6-D half active, inactive) at
  seeded random states of the gripper frame, and the energies, to 1e-12;
- ``node_calc_diff`` at contact-active, inactive and friction-cone nodes of
  JAX's monkey_bar (dt 40) and eagle_catch (dt 50) solutions, and at
  contact-active nodes of monkey_bar with its contact switched to a 6-D
  one, to 1e-10 relative to each field's largest entry;
- three FDDP iterations of monkey_bar at dt 100 (T = 18): the same steps,
  costs to 1e-8;
- the invariants of tests/test_contacts.py at JAX's solutions through the
  port's plain functions, the kernels' descriptor of a contact spec, and
  ``convert`` on contact specs and parameters.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from eagle_mpc_tpu.config import specs as jspecs
from eagle_mpc_tpu.ocp import problem as JP
from eagle_mpc_tpu_torch import config as port_config
from eagle_mpc_tpu_torch import convert
from eagle_mpc_tpu_torch.dynamics import rbd
from eagle_mpc_tpu_torch.ocp import actuation as act
from eagle_mpc_tpu_torch.ocp import costs as C
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.ops import _cuda
from eagle_mpc_tpu_torch.solvers import fddp

from torch_port_util import CPU, F64, FLAGSHIP, MISSIONS, rel_err, t

CONTACTS = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torch_port_contacts.npz")
EULER = "IntegratedActionModelEuler"
# fixture key -> (mission, dt in ms, 6-D variant)
CASES = {"mb": ("monkey_bar", 40, False), "ec": ("eagle_catch", 50, False),
         "ecr": ("eagle_catch", 50, False), "m6": ("monkey_bar", 40, True)}


def build(mission, dt_ms, six=False):
    traj = port_config.load_trajectory(
        f"{FLAGSHIP}/trajectories/{mission}.yaml", yaml_dir=MISSIONS)
    if six:
        traj = P.contact_6d(traj)
    return P.from_trajectory(traj, dt_ms=dt_ms, use_squash=True,
                             integrator=EULER, device=CPU)


@pytest.fixture(scope="module")
def fx():
    return np.load(CONTACTS)


@pytest.fixture(scope="module")
def model(fx):
    return build("monkey_bar", 40)[0].model


def test_frame_kinematics_match_jax(fx, model):
    x = t(fx["dyn_x"])
    q, v = x[:, :model.nq], x[:, model.nq:]
    fid = int(fx["dyn_frame"])
    got = {"J6": rbd.frame_jacobian_local(model, q, fid),
           "drift": rbd.frame_accel_drift(model, q, v, fid),
           "vf": rbd.frame_velocity(model, q, v, fid)}
    for name, g in got.items():
        assert rel_err(fx[f"dyn_{name}"], g) < 1e-12, name


@pytest.mark.parametrize("case", ["3", "6", "mix", "in"])
def test_contact_fwd_dynamics_matches_jax(fx, model, case):
    """3-D rows active (a0 the drift plus w x v), 6-D rows active (a0 the
    drift), 6-D with only the linear rows active, and 3-D rows inactive with
    a random a0, which is free dynamics exactly."""
    x, tau = t(fx["dyn_x"]), t(fx["dyn_tau"])
    q, v = x[:, :model.nq], x[:, model.nq:]
    J6, drift, vf = (t(fx[f"dyn_{n}"]) for n in ("J6", "drift", "vf"))
    rows = {
        "3": (J6[:, :3], drift[:, :3] + torch.linalg.cross(vf[:, 3:], vf[:, :3]),
              torch.ones(3, dtype=F64)),
        "6": (J6, drift, torch.ones(6, dtype=F64)),
        "mix": (J6, drift, t([1.0, 1, 1, 0, 0, 0])),
        "in": (J6[:, :3], t(fx["dyn_a0"]), torch.zeros(3, dtype=F64)),
    }[case]
    a, lam = rbd.contact_fwd_dynamics(model, q, v, tau, *rows)
    assert rel_err(fx[f"dyn_a{case}"], a) < 1e-12
    assert rel_err(fx[f"dyn_lam{case}"], lam) < 1e-12
    if case == "in":
        assert torch.equal(lam, torch.zeros_like(lam))
        assert rel_err(fx["dyn_afree"], a) < 1e-12
    else:
        J, a0, active = rows
        res = (J @ a[..., None])[..., 0] + a0
        assert float((active * res).abs().max()) < 1e-9


def test_energies_match_jax(fx, model):
    x = t(fx["dyn_x"])
    q, v = x[:, :model.nq], x[:, model.nq:]
    np.testing.assert_allclose(rbd.kinetic_energy(model, q, v).numpy(),
                               fx["dyn_ke"], rtol=1e-12)
    np.testing.assert_allclose(rbd.potential_energy(model, q).numpy(),
                               fx["dyn_pe"], rtol=1e-12)


def _node_derivs(spec, params, xs, us, nodes):
    """``problem.node_calc_diff`` at the given nodes of one solution."""
    pb = P.expand_params(params, 1)
    n = len(nodes)
    view = P.node_views(pb.node, (0, list(nodes)))
    glob = P.map_params(lambda a: a.expand((n,) + a.shape[1:]), pb.glob)
    return P.node_calc_diff(spec, view, glob, xs[list(nodes)],
                            us[list(nodes)])


@pytest.mark.parametrize("key", list(CASES))
def test_node_calc_diff_matches_jax(fx, key):
    """mb: hang nodes 1, 15, 29 (contact active) and 35 (free); ec: 31, 34
    (contact and friction cone) and 50 (free); ecr: ec's 31 and 34 at a
    rough candidate, where the cone's barrier is active; m6: mb's nodes 1
    and 15 with a 6-D contact."""
    spec, params = build(*CASES[key])
    sol = {"m6": "mb"}.get(key, key)
    nodes = fx[f"{key}_nodes"].tolist()
    got = _node_derivs(spec, params, t(fx[f"{sol}_xs"]), t(fx[f"{sol}_us"]),
                       nodes)
    for name in got._fields:
        assert rel_err(fx[f"{key}_cd_{name}"], getattr(got, name)) < 1e-10, name
    if key == "ecr":   # the active cone couples x and u through the forces
        assert float(got.Lxu.abs().max()) > 0.0
    assert spec.contacts[0].dim == (6 if key == "m6" else 3)


def _hold_at(spec, params, x, s, smooth, t_node):
    """(J a + a0, forces, frame rotation) of the node's constrained
    dynamics at (x, s) under the squash smoothness ``smooth``."""
    pb = P.expand_params(params, 1)
    view = P.node_views(pb.node, (0, t_node))
    glob = P.map_params(lambda a: a[0], pb.glob)._replace(
        squash_smooth=torch.tensor(smooth, dtype=F64))
    J, a0, _ = P._contact_rows(spec, view, x)
    a, u, forces = P._dam(spec, view, glob, x, s)
    _, R = rbd.frame_placement(spec.model, x[:spec.model.nq],
                               spec.contacts[0].frame_id)
    return J @ a + a0, forces, R


def test_contact_invariants_at_jax_solutions(fx):
    """tests/test_contacts.py's checks through the port's plain functions:
    J a + a0 = 0 at monkey_bar's hang nodes 1, 15 and 29, the gripper near
    its start there, the perch target; eagle_catch's world normal force at
    its middle contact node is not negative."""
    spec, params = build("monkey_bar", 40)
    xs, us = t(fx["mb_xs"]), t(fx["mb_us"])
    fid = spec.contacts[0].frame_id
    p0 = rbd.frame_placement(spec.model, xs[0, :spec.model.nq], fid)[0]
    for t_node, tol in ((1, 1e-2), (15, 6e-2), (29, 9e-2)):
        res, _, _ = _hold_at(spec, params, xs[t_node], us[t_node],
                             float(fx["mb_smooth"]), t_node)
        assert float(res.abs().max()) < 1e-6
        p = rbd.frame_placement(spec.model, xs[t_node, :spec.model.nq], fid)[0]
        assert float((p - p0).abs().max()) < tol
    assert float((xs[-1, :3] - t([1.0, 0.0, 0.5])).abs().max()) < 0.1
    spec, params = build("eagle_catch", 50)
    xs, us = t(fx["ec_xs"]), t(fx["ec_us"])
    _, forces, R = _hold_at(spec, params, xs[34], us[34],
                            float(fx["ec_smooth"]), 34)
    assert float((R @ forces[0][:3])[2]) > -1e-6


def test_three_iterations_match_jax(fx):
    """fddp.solve_fddp on monkey_bar at dt 100 from default_init, three
    iterations: the same accepted steps and phases, costs to 1e-8. The
    states are held to 1e-5 only: from this start (cost 4.7e4) the solve
    amplifies round-off about 1e6-fold (a 1e-13 change of x0 moves the
    states 1.4e-7 after three steps), and they land 9.4e-7 from JAX's while
    the node derivatives agree to 1e-15 there."""
    spec, params = build("monkey_bar", 100)
    assert spec.T == 18
    pb = P.expand_params(params, 1)
    xs0, us0 = fddp.default_init(spec, pb)
    r = fddp.solve_fddp(spec, fddp.SolverSettings(record_trace=True), pb, xs0,
                        us0, 3, 1e-9)
    for name in ("iters", "feasible", "failed"):
        assert getattr(r, name)[0].item() == fx[f"it_{name}"].item(), name
    tr = fddp.IterTrace(*(a[0].numpy() for a in r.trace))
    for name in ("accepted", "phase", "steplength"):
        np.testing.assert_array_equal(getattr(tr, name),
                                      fx[f"it_trace_{name}"], err_msg=name)
    np.testing.assert_allclose(tr.cost, fx["it_trace_cost"], rtol=1e-8)
    np.testing.assert_allclose(r.cost[0].item(), fx["it_cost"], rtol=1e-8)
    np.testing.assert_allclose(r.xs[0].numpy(), fx["it_xs"], rtol=0, atol=1e-5)


def test_total_cost_runs_the_contact_dynamics(fx):
    """A contact spec's total_cost is the full node evaluation (the cone
    needs the forces): it equals the sum of node_calc's costs and the
    terminal cost, and differs from the rollout-free sum at eagle_catch's
    solution."""
    spec, params = build("eagle_catch", 50)
    pb = P.expand_params(params, 1)
    xs, us = t(fx["ec_xs"])[None], t(fx["ec_us"])[None]
    got = P.total_cost(spec, pb, xs, us)
    views = P.running_views(pb.node, spec.T)
    _, costs, _ = P.node_calc(spec, views, P.glob_over_nodes(pb.glob),
                              xs[:, :spec.T], us)
    cT = P.terminal_calc(spec, P.terminal_view(pb.node, spec.T), pb.glob,
                         xs[:, spec.T])
    np.testing.assert_allclose(got.numpy(), (costs.sum(1) + cT).numpy(),
                               rtol=1e-14)
    free = spec.dt * P._point_cost(spec, views, P.glob_over_nodes(pb.glob),
                                   xs[:, :spec.T], us, False).sum(1) + cT
    assert float((got - free).abs().max()) > 0.0


@pytest.mark.parametrize("key", ["mb", "m6"])
def test_descriptor_of_a_contact_spec(key):
    """The kernels' descriptor and node rows of a contact spec: the
    contacts' frames, rows and gains, their activity and references after
    the slots' in each node row; eagle_catch's cone slot for its contact."""
    spec, params = build(*CASES[key])
    d = _cuda.make_descriptor(spec)
    c = spec.contacts[0]
    assert (d.n_con, d.nc, d.con_dim[0], d.con_row[0]) == (1, c.dim, c.dim, 0)
    assert d.con_body[0] == spec.model.frames[c.frame_id].body
    assert tuple(d.con_gain[:2]) == c.gains == (10.0, 5.0)
    pb = P.expand_params(params, 2)
    node_rows, _ = _cuda.pack_params(spec, pb, F64, CPU)
    assert torch.equal(node_rows[..., d.con_act_off],
                       pb.node.contact_active[:, :spec.T, 0])
    off = d.con_ref_off[0]
    assert torch.equal(node_rows[..., off:off + c.ref_dim],
                       pb.node.contact_refs[0][:, :spec.T])
    assert d.node_dim == node_rows.shape[-1] == off + c.ref_dim
    espec = build("eagle_catch", 50)[0]
    ed = _cuda.make_descriptor(espec)
    k = [s.kind for s in espec.slots].index(C.FRICTION_CONE)
    assert ed.slot_contact[k] == 0 and ed.slot_kind[k] == 6
    np.testing.assert_array_equal(np.array(ed.slot_cone[15 * k:15 * k + 15]),
                                  np.array(espec.slots[k].cone_A).reshape(-1))


def _modules(obj, seen=None):
    """Modules of the types of every field and leaf reachable from obj."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return set()
    seen.add(id(obj))
    mods = {type(obj).__module__}
    if dataclasses.is_dataclass(obj):
        children = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        children = list(obj)
    elif isinstance(obj, dict):
        children = list(obj.values())
    else:
        children = []
    for c in children:
        mods |= _modules(c, seen)
    return mods


@pytest.mark.parametrize("mission,dt_ms", [("monkey_bar", 40),
                                           ("eagle_catch", 50)])
def test_convert_carries_contacts(mission, dt_ms):
    """spec_from_jax / params_from_jax on the JAX package's contact problem
    give the port's own from_trajectory result, built field by field: no
    field or leaf of the spec is an object of a module outside this package
    but builtins and numpy."""
    rel = f"{FLAGSHIP}/trajectories/{mission}.yaml"
    jspec, jparams = JP.from_trajectory(
        jspecs.load_trajectory(rel, yaml_dir=MISSIONS), dt_ms=dt_ms,
        use_squash=True, integrator=EULER)
    spec, params = build(mission, dt_ms)
    got = convert.spec_from_jax(jspec)
    assert got == spec
    assert all(isinstance(c, P.ContactSlot) for c in got.contacts)
    mods = _modules(got)
    assert all(m in ("builtins", "numpy") or m.startswith("eagle_mpc_tpu_torch")
               for m in mods), mods
    conv = convert.params_from_jax(jparams, CPU, F64)
    assert torch.equal(conv.node.contact_active, params.node.contact_active)
    for a, b in zip(conv.node.contact_refs, params.node.contact_refs):
        assert torch.equal(a, b)
    assert len(conv.node.contact_refs) == len(spec.contacts)


def test_dam_masks_the_contact():
    """_dam runs the constrained dynamics at every node of a contact spec:
    where the contact is active (monkey_bar's hang, node 1 at dt 100) the
    acceleration differs from free dynamics, where it is not (the swing,
    node 15) it equals them exactly, with zero forces."""
    spec, params = build("monkey_bar", 100)
    pb = P.expand_params(params, 1)
    glob = pb.glob
    s = torch.linspace(-1.0, 3.0, spec.nu, dtype=F64)[None]
    x = pb.x0
    nq = spec.model.nq
    tau = act.actuation_tau(P.tau_f_tensor(spec, CPU, F64),
                            P.squash(spec, glob, s))
    a_free = rbd.fwd_dynamics(spec.model, x[:, :nq], x[:, nq:], tau)
    for node, hangs in ((1, True), (15, False)):
        view = P.node_views(pb.node, (slice(None), node))
        assert float(view.contact_active[0, 0]) == float(hangs)
        a, _, forces = P._dam(spec, view, glob, x, s)
        assert len(forces) == 1 and forces[0].shape == (1, 3)
        if hangs:
            assert not torch.allclose(a, a_free)
        else:
            assert torch.equal(forces[0], torch.zeros_like(forces[0]))
            np.testing.assert_allclose(a.numpy(), a_free.numpy(), rtol=0,
                                       atol=1e-12)
