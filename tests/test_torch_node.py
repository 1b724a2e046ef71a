"""Node linearization (kernel K1's plain version) against the JAX package,
the structure kernel K1 rests on, and the CUDA wrappers' dispatch and
scope rules.

The port's ``calc_diff_all`` on the CPU runs ``problem.node_calc_diff``
over the flattened nodes; it is held against the JAX package's XLA path
(``pallas_nodes=False``) for the flagship CarrotMpc at B=2 on the
perturbed candidates of tests/test_node_pallas.py, at t in {500, 3500} ms,
to 1e-10 relative to each field's largest entry (float64). The JAX values
(and those of ``total_cost``) are the fixture's (``cd_*``, ``tc_*`` in
tests/fixtures/torch_port_flagship.npz, from
tools/make_torch_port_fixtures.py): jit-compiling them here took most of
these tests' time.
"""

import dataclasses

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch.dynamics import rbd
from eagle_mpc_tpu_torch.ocp import actuation as act
from eagle_mpc_tpu_torch.ocp import costs as C
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.ops import _cuda, node_cuda, riccati_cuda, rollout_cuda

from torch_port_util import FIXTURE, candidates, controllers, rel_err, t

TOL = 1e-10
B = 2


@pytest.fixture(scope="module")
def ctrls():
    return controllers()


def test_calc_diff_all_matches_jax(ctrls):
    jc, tc = ctrls
    fx = np.load(FIXTURE)
    xs, us = candidates(jc.spec, jc.params0.x0, B)
    assert np.array_equal(xs, fx["cd_xs"]) and np.array_equal(us, fx["cd_us"])
    params = tc.update_problem(
        t(fx["cd_t"]), P.expand_params(tc.params0, B)._replace(x0=t(xs[:, 0])))
    got, got_term = P.calc_diff_all(tc.spec, params, t(xs), t(us))
    for name in got._fields:
        assert rel_err(fx[f"cd_{name}"], getattr(got, name)) < TOL, name
    for name, b in zip(("cost", "Lx", "Lxx"), got_term):
        assert rel_err(fx[f"cd_term_{name}"], b) < TOL, name


def test_dynamics_jacobian_by_implicit_function(ctrls):
    """The identity kernel K1 differentiates the dynamics by:
    RNEA(x (+) z, a(z)) = tau(s + dz) along z = (dx, ds), so
    da/dz = M^-1 (dtau/dz - dRNEA(x (+) z, a)/dz with a held). Checked
    against forward-mode AD of rbd.fwd_dynamics at flagship candidate
    states, float64, to 1e-10 relative."""
    spec = ctrls[1].spec
    glob = ctrls[1].params0.glob
    st, model, nq, ndx = spec.state, spec.model, spec.model.nq, spec.state.ndx
    xs, us = candidates(spec, ctrls[0].params0.x0, 2, seed=3)
    x, s = t(xs[:, :3].reshape(-1, model.nx)), t(us[:, :3].reshape(-1, spec.nu))
    tau_f = P.tau_f_tensor(spec, x.device, x.dtype)

    def tau(z):
        return act.actuation_tau(tau_f, P.squash(spec, glob, s + z[..., ndx:]))

    def accel(z):
        xx = st.integrate(x, z[..., :ndx])
        return rbd.fwd_dynamics(model, xx[..., :nq], xx[..., nq:], tau(z))

    z0 = torch.zeros(x.shape[0], ndx + spec.nu, dtype=torch.float64)
    a0, want = P._jacobian(accel, z0)

    def rnea_held(z):
        xx = st.integrate(x, z[..., :ndx])
        return rbd.rnea(model, xx[..., :nq], xx[..., nq:], a0)

    dtau = P._jacobian(tau, z0)[1]
    drnea = P._jacobian(rnea_held, z0)[1]
    got = torch.linalg.solve(rbd.crba(model, x[..., :nq]), dtau - drnea)
    assert rel_err(want.numpy(), got) < TOL


def test_lxu_is_zero_for_state_and_control_slots(ctrls):
    """STATE residuals depend on x alone and CONTROL residuals on s alone,
    so the Gauss-Newton cross term Lxu is exactly zero (kernel K1 writes
    zeros); the plain path agrees."""
    tc = ctrls[1]
    xs, us = candidates(tc.spec, ctrls[0].params0.x0, 1, seed=2)
    params = tc.update_problem(t([3500.0]), P.expand_params(tc.params0, 1)
                               ._replace(x0=t(xs[:, 0])))
    d = node_cuda.calc_diff_running_plain(tc.spec, params, t(xs), t(us))
    assert float(d.Lxu.abs().max()) <= 1e-14
    assert float(d.Lxx.abs().max()) > 0 and float(d.Luu.abs().max()) > 0


def test_total_cost_matches_jax(ctrls):
    jc, tc = ctrls
    fx = np.load(FIXTURE)
    xs, us = candidates(jc.spec, jc.params0.x0, B, seed=1)
    assert np.array_equal(xs, fx["tc_xs"]) and np.array_equal(us, fx["tc_us"])
    params = tc.update_problem(
        t(fx["tc_t"]), P.expand_params(tc.params0, B)._replace(x0=t(xs[:, 0])))
    got = P.total_cost(tc.spec, params, t(xs), t(us))
    assert rel_err(fx["tc_cost"], got) < TOL


def test_pack_params_matches_descriptor(ctrls):
    """The kernels' parameter rows sit where the descriptor says."""
    tc = ctrls[1]
    spec = tc.spec
    params = tc.update_problem(t([3500.0, 4050.0]),
                               P.expand_params(tc.params0, B))
    node_rows, glob_rows = _cuda.pack_params(spec, params, torch.float64,
                                             params.x0.device)
    d = _cuda.make_descriptor(spec)
    K = len(spec.slots)
    assert node_rows.shape == (B, spec.T, d.node_dim)
    assert glob_rows.shape == (B, d.glob_dim)
    assert torch.equal(node_rows[..., :K], params.node.weight[:, :spec.T])
    assert torch.equal(node_rows[..., K:2 * K], params.node.active[:, :spec.T])
    for k, slot in enumerate(spec.slots):
        off = d.slot_ref_off[k]
        assert torch.equal(node_rows[..., off:off + slot.ref_dim],
                           params.node.refs[k][:, :spec.T])
        off = d.slot_glob_off[k]
        for j, leaf in enumerate((params.glob.act_w, params.glob.lb,
                                  params.glob.ub)):
            seg = glob_rows[:, off + j * slot.nr:off + (j + 1) * slot.nr]
            assert torch.equal(seg, leaf[k])
    assert d.n_res == sum(s.nr for s in spec.slots)
    assert (d.nj, d.nq, d.nv, d.nu, d.n_rot) == (3, 10, 9, 9, 6)
    # params that do not fit the spec's layout are refused
    short = params._replace(node=params.node._replace(
        refs=(params.node.refs[0][..., :-1],) + params.node.refs[1:]))
    with pytest.raises(ValueError):
        _cuda.pack_params(spec, short, torch.float64, params.x0.device)


@pytest.mark.parametrize("change", ["rk4", "no_slots", "frame_cost",
                                    "contacts", "friction_cone",
                                    "contact_rows", "cone_contact",
                                    "rk4_contacts"])
def test_out_of_scope_spec_raises(ctrls, change):
    """The kernels take Euler or RK4, free or contact dynamics with up to
    6 constraint rows (one 6-D contact or two 3-D ones), and 0 to 12 STATE
    / CONTROL / frame / friction-cone slots; any other spec raises instead
    of running a different path. Raise: frame_cost, a frame slot past the
    12 the kernels hold; contact_rows, a 6-D and a 3-D contact (9 rows);
    cone_contact, a cone on a contact the spec lacks. Taken: rk4, the RK4
    integrator in free flight (the descriptor says so); rk4_contacts, RK4
    with a contact, a contact and its friction cone, or a cone without a
    contact (packed as the Euler contact spec, integrator 1); no_slots, the
    slot-less spec (as the JAX package evaluates it), with a contact too;
    contacts, the gripper's 3-D or 6-D contact, or two 3-D ones;
    friction_cone, a cone on the gripper's contact."""
    spec = ctrls[1].spec
    grip = C.CostSlot("grip", C.FRAME_TRANSLATION, C.QUAD, 3, 3, frame_id=0)
    fid = spec.model.frame_id("flying_arm_3__gripper")
    c3 = P.ContactSlot("grip3", fid, 3, 3, (10.0, 5.0))
    c6 = P.ContactSlot("grip6", fid, 6, 7)
    cone = C.CostSlot("cone", C.FRICTION_CONE, C.QBARRIER, 5, 0, frame_id=fid,
                      contact_id=0, cone_A=tuple(map(tuple, C.friction_cone_matrix(
                          [0.0, 0.0, 1.0], 0.7))))
    change_spec = lambda **kw: dataclasses.replace(spec, **kw)
    bad = {
        "frame_cost": dict(slots=spec.slots + (grip,) * (
            _cuda.MAX_SLOTS + 1 - len(spec.slots))),
        "contact_rows": dict(contacts=(c6, c3)),
        "cone_contact": dict(slots=spec.slots + (cone._replace(contact_id=1),),
                             contacts=(c3,)),
    }
    rk4_contacts = [dict(integrator=P.RK4, contacts=(c3,)),
                    dict(integrator=P.RK4, slots=spec.slots + (cone,),
                         contacts=(c3,)),
                    dict(integrator=P.RK4, slots=spec.slots + (
                        cone._replace(contact_id=-1),))]
    taken = {
        "rk4": [dict(integrator=P.RK4)],
        "rk4_contacts": rk4_contacts,
        "no_slots": [dict(slots=()), dict(slots=(), contacts=(c3,))],
        "frame_cost": [dict(slots=spec.slots + (grip,) * (
            _cuda.MAX_SLOTS - len(spec.slots)))],
        "contacts": [dict(contacts=(c3,)), dict(contacts=(c6,)),
                     dict(contacts=(c3, c3._replace(name="b")))],
        "friction_cone": [dict(slots=spec.slots + (cone,), contacts=(c3,))],
    }
    if change in bad:
        with pytest.raises(NotImplementedError):
            _cuda.make_descriptor(change_spec(**bad[change]))
    if change == "rk4_contacts":
        # each packs as its Euler twin does, with the RK4 integrator
        for kw in rk4_contacts:
            d = _cuda.make_descriptor(change_spec(**kw))
            euler = _cuda.make_descriptor(change_spec(**dict(kw, integrator=P.EULER)))
            assert d.integrator == 1 and euler.integrator == 0
            euler.integrator = 1
            assert bytes(d) == bytes(euler)
        cones = [_cuda.make_descriptor(change_spec(**kw)).slot_contact[
            len(spec.slots)] for kw in rk4_contacts[1:]]
        assert cones == [0, -1]
    for kw in taken.get(change, ()):
        d = _cuda.make_descriptor(change_spec(**kw))
        assert d.n_con == len(kw.get("contacts", ()))
        assert d.nc == sum(c.dim for c in kw.get("contacts", ()))
    if change == "rk4":
        assert _cuda.make_descriptor(change_spec(integrator=P.RK4)).integrator == 1
        assert _cuda.make_descriptor(spec).integrator == 0
    if change == "no_slots":
        d = _cuda.make_descriptor(change_spec(slots=()))
        assert (d.n_slots, d.n_res, d.node_dim) == (0, 0, 0)
        assert d.glob_dim == 1 + 2 * spec.nu
    if change == "friction_cone":
        d = _cuda.make_descriptor(change_spec(slots=spec.slots + (cone,),
                                              contacts=(c3,)))
        assert d.slot_contact[len(spec.slots)] == 0


def test_wrappers_refuse_other_devices(ctrls):
    """CPU tensors take the plain version, CUDA tensors the kernel; any
    other device raises (here the meta device, which has no data)."""
    tc = ctrls[1]
    spec = tc.spec
    meta = torch.device("meta")
    params = P.map_params(lambda a: a.to(meta), P.expand_params(tc.params0, 1))
    xs = torch.empty(1, spec.T + 1, spec.model.nx, device=meta,
                     dtype=torch.float64)
    us = torch.empty(1, spec.T, spec.nu, device=meta, dtype=torch.float64)
    with pytest.raises(ValueError):
        node_cuda.calc_diff_running(spec, params, xs, us)
    alphas = torch.ones(2, device=meta, dtype=torch.float64)
    keep = torch.zeros(1, 2, device=meta, dtype=torch.bool)
    with pytest.raises(ValueError):
        rollout_cuda.rollout(spec, params, xs, us, us, None, None, alphas, keep)
    z = torch.empty(1, spec.T, 18, device=meta, dtype=torch.float64)
    with pytest.raises(ValueError):
        riccati_cuda.backward(*([z] * 13))


def test_check_tensor_rejects_mismatches():
    x = torch.zeros(2, 3, dtype=torch.float64)
    _cuda.check_tensor(x, "x", (2, 3), torch.float64, x.device)
    with pytest.raises(ValueError):
        _cuda.check_tensor(x, "x", (3, 2), torch.float64, x.device)
    with pytest.raises(ValueError):
        _cuda.check_tensor(x, "x", (2, 3), torch.float32, x.device)
    with pytest.raises(ValueError):
        _cuda.check_tensor(x.T, "x", (3, 2), torch.float64, x.device)
