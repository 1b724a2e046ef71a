"""The RK4 integrator of the PyTorch port against the JAX package, float64
on the CPU (the kernels' plain versions).

The JAX values are tests/fixtures/torch_port_rk4.npz (made by
``tools/make_torch_port_fixtures.py rk4``; no JAX function is compiled
here):

- ``_stage_points`` and ``node_calc`` on the flagship at dt 20 ms at seeded
  states (1e-12) and ``node_calc_diff`` there (1e-9 relative to each
  output's largest entry; Lxu is not zero under RK4);
- the plain K1 (``node_cuda``) on the flagship CarrotMpc with RK4 nodes at
  B=2, and the plain K2 (``rollout_cuda`` through the FDDP forward pass,
  with and without the clip) on iris hover at dt 60 ms for every alpha;
- ``total_cost``, three FDDP iterations and the offline solve of
  tests/test_missions.py (iris hover, dt 60, maxiter 100);
- a CarrotMpc with RK4 nodes on iris hover (tests/test_mpc.py's
  ``TestRk4ClosedLoop``): its update and one closed-loop tick;
- monkey_bar contact nodes with RK4 on the plain path, and ``convert``
  carrying the integrator.
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
from eagle_mpc_tpu_torch.mpc import CarrotMpc, run_closed_loop
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.sim import AerialSimulator
from eagle_mpc_tpu_torch.solvers import fddp, sbfddp

from torch_port_util import CPU, F64, FLAGSHIP, MISSIONS, load_port, rel_err, t

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
RK4 = "IntegratedActionModelRK4"
TOL = 1e-9
CL_NAMES = ("states", "controls", "solve_iters", "costs", "xs", "us")


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(os.path.join(FIXTURES, "torch_port_rk4.npz")))


def _build(rel, dt_ms):
    traj = port_config.load_trajectory(rel, yaml_dir=MISSIONS)
    return P.from_trajectory(traj, dt_ms=dt_ms, use_squash=True,
                             integrator=RK4, device=CPU)


@pytest.fixture(scope="module")
def dt20():
    """The flagship mission at dt 20 ms with RK4 nodes (unbatched)."""
    return _build(f"{FLAGSHIP}/trajectories/displacement.yaml", 20)


@pytest.fixture(scope="module")
def hover():
    """iris hover at dt 60 ms with RK4 nodes, B = 1."""
    spec, params = _build("iris/trajectories/hover.yaml", 60)
    return spec, P.expand_params(params, 1)


def _samples(spec, params, fx):
    for i, node in enumerate(fx["sp_nodes"]):
        yield (i, P.node_views(params.node, int(node)), t(fx["sp_x"][i]),
               t(fx["sp_s"][i]))


def test_stage_points_and_node_calc_match_jax(fx, dt20):
    spec, params = dt20
    assert spec.integrator == P.RK4
    for i, view, x, s in _samples(spec, params, fx):
        pts, xnext, usq = P._stage_points(spec, view, params.glob, x, s)
        assert [c for c, _, _ in pts] == [spec.dt / 6, spec.dt / 3,
                                          spec.dt / 3, spec.dt / 6]
        assert rel_err(fx["sp_pts"][i], torch.stack([p for _, p, _ in pts])) < 1e-12
        assert rel_err(fx["sp_pts_xnext"][i], xnext) < 1e-12
        assert rel_err(fx["sp_usq"][i], usq) < 1e-12
        xn, cost, _ = P.node_calc(spec, view, params.glob, x, s)
        assert rel_err(fx["sp_xnext"][i], xn) < 1e-12
        assert rel_err(fx["sp_cost"][i], cost) < 1e-12


def test_node_calc_diff_matches_jax(fx, dt20):
    """RK4's derivatives over z = (dx, ds), Gauss-Newton over the stacked
    rows of the four stage points: the residuals at y1..y3 depend on s
    through the accelerations, so Lxu is not zero."""
    spec, params = dt20
    for i, view, x, s in _samples(spec, params, fx):
        d = P.node_calc_diff(spec, view, params.glob, x, s)
        for name in d._fields:
            assert rel_err(fx[f"sp_cd_{name}"][i], getattr(d, name)) < TOL, name
        assert float(d.Lxu.abs().max()) > 1e-6 * float(d.Luu.abs().max())


@pytest.fixture(scope="module")
def flagship_rk4():
    """The port's flagship CarrotMpc with RK4 nodes."""
    traj, mp = load_port(FLAGSHIP)
    ref = port_config.load_ref(FLAGSHIP, "displacement", 30, traj=traj)[0]
    return CarrotMpc(mpc_params=dataclasses.replace(
        mp, integration_method=RK4), trajectory=traj, state_ref=ref,
        dt_ref=30, device=CPU, dtype=F64)


def test_plain_node_kernel_matches_jax(fx, flagship_rk4):
    """K1's plain version (``calc_diff_all`` on the CPU) on the RK4 carrot
    at B=2 against the JAX package's XLA path, running and terminal
    nodes."""
    ctrl = flagship_rk4
    assert ctrl.spec.integrator == P.RK4
    B = fx["cd_xs"].shape[0]
    params = ctrl.update_problem(t(fx["cd_t"]), P.expand_params(
        ctrl.params0, B)._replace(x0=t(fx["cd_x0"])))
    got, term = P.calc_diff_all(ctrl.spec, params, t(fx["cd_xs"]),
                                t(fx["cd_us"]))
    for name in got._fields:
        assert rel_err(fx[f"cd_{name}"], getattr(got, name)) < TOL, name
    for name, b in zip(("cost", "Lx", "Lxx"), term):
        assert rel_err(fx[f"cd_term_{name}"], b) < TOL, name


@pytest.mark.parametrize("box", [False, True])
def test_plain_rollout_matches_jax(fx, hover, box):
    """K2's plain version through ``fddp._forward_pass_multi`` on iris hover
    (RK4 nodes) for the 10 alphas, element 0 infeasible (the gaps
    contracted) and element 1 feasible; with ``box`` the controls are
    clipped. The rollout's states, controls and costs (each node's the
    RK4 quadrature) against JAX's ``_forward_pass``."""
    spec, pb = hover
    key = "fpbox" if box else "fp"
    settings = fddp.SolverSettings()
    B = fx["fp_xs"].shape[0]
    params = P.expand_params(P.map_params(lambda a: a[0], pb), B)
    k, K, fs = (t(fx[f"fp_{n}"]) for n in ("k", "K", "fs"))
    bp = fddp.BackwardPassData(k=k, K=K, Qu=k, Quuk=k, Vx=fs, Vxx=None,
                               ok=None)
    alphas = torch.tensor(settings.alphas, dtype=F64)
    got = fddp._forward_pass_multi(
        spec, settings, params, t(fx["fp_xs"]), t(fx["fp_us"]), bp, fs,
        alphas, torch.as_tensor(fx["fp_feasible"]), ddp=False, box=box)
    diverged = fx[f"{key}_diverged"]
    assert np.array_equal(diverged, got[3].numpy())
    ok = ~diverged
    assert ok.sum() >= 10
    if box:
        lb, ub = params.glob.s_lb[0], params.glob.s_ub[0]
        assert bool(((got[1] == lb) | (got[1] == ub)).any())
    for name, b in zip(("xs_try", "us_try", "cost_try"), got[:3]):
        assert rel_err(fx[f"{key}_{name}"][ok], b.numpy()[ok]) < TOL, name


def test_total_cost_matches_jax(fx, hover):
    """RK4's total cost evaluates the whole node (the quadrature needs the
    stage points), as the JAX package's ``calc_all``."""
    spec, pb = hover
    B = fx["fp_xs"].shape[0]
    params = P.expand_params(P.map_params(lambda a: a[0], pb), B)
    got = P.total_cost(spec, params, t(fx["fp_xs"]), t(fx["fp_us"]))
    assert rel_err(fx["tc_cost"], got) < 1e-12


def test_three_fddp_iterations_match_jax(fx, hover):
    spec, pb = hover
    xs0, us0 = fddp.default_init(spec, pb)
    r = fddp.solve_fddp(spec, fddp.SolverSettings(), pb, xs0, us0, 3, 1e-9)
    for name in ("iters", "feasible", "failed"):
        assert getattr(r, name)[0].item() == fx[f"it_{name}"].item(), name
    np.testing.assert_allclose(r.cost[0].item(), fx["it_cost"], rtol=1e-8)
    np.testing.assert_allclose(r.xs[0].numpy(), fx["it_xs"], rtol=0, atol=1e-8)


def test_offline_solve_matches_jax(fx, hover):
    """tests/test_missions.py's RK4 mission: iris hover at dt 60 solved to
    its target, as the JAX package solves it."""
    spec, pb = hover
    r = sbfddp.solve(spec, pb, maxiter=100)
    assert bool(r.feasible[0]) and not bool(r.failed[0])
    assert int(r.iters[0]) == int(fx["off_iters"])
    np.testing.assert_allclose(r.cost[0].item(), fx["off_cost"], rtol=1e-8)
    xT = r.xs[0, -1].numpy()
    np.testing.assert_allclose(xT[:3], [0.0, 0.0, 2.5], atol=0.08)
    np.testing.assert_allclose(r.xs[0].numpy(), fx["off_xs"], rtol=0, atol=1e-6)
    u, lb, ub = r.us_squash[0], pb.glob.s_lb[0], pb.glob.s_ub[0]
    assert bool(((u >= lb - 1e-9) & (u <= ub + 1e-9)).all())


def test_carrot_mpc_with_rk4_nodes(fx):
    """A CarrotMpc whose mpc.yaml selects IntegratedActionModelRK4: its
    spec integrates with RK4, its update equals the JAX package's, and one
    closed-loop tick (the while-loop route) matches JAX's, its controls
    within their bounds."""
    traj, mp = load_port("iris", "hover")
    with np.load(os.path.join(FIXTURES, "torch_port_closed_loop.npz")) as z:
        ixs, ius = z["iris_xs"], z["iris_us"]
    ctrl = CarrotMpc(mpc_params=dataclasses.replace(
        mp, integration_method=RK4), trajectory=traj, state_ref=ixs,
        dt_ref=40, device=CPU, dtype=F64)
    assert ctrl.spec.integrator == P.RK4
    for i, tm in enumerate(fx["mpc_t"]):
        u = ctrl.update_problem(t([tm]), P.expand_params(ctrl.params0, 1))
        np.testing.assert_array_equal(u.node.active[0].numpy(),
                                      fx["mpc_active"][i])
        np.testing.assert_allclose(u.node.weight[0].numpy(),
                                   fx["mpc_weight"][i], rtol=1e-14)
        for k in range(len(ctrl.spec.slots)):
            np.testing.assert_allclose(u.node.refs[k][0].numpy(),
                                       fx[f"mpc_ref{k}"][i], rtol=1e-12,
                                       atol=1e-14)
    T = ctrl.spec.T
    pad = max(0, T + 1 - ixs.shape[0])
    xs_w = np.vstack([ixs, np.tile(ixs[-1], (pad, 1))])[:T + 1]
    us_w = np.vstack([ius, np.tile(ius[-1], (pad, 1))])[:T]
    sim = AerialSimulator.from_platform(mp.model, mp.platform, 10, device=CPU,
                                        dtype=F64)
    out = run_closed_loop(ctrl, sim, t(ixs[:1]), t(xs_w[None]), t(us_w[None]),
                          n_steps=1, dt_sim_ms=10.0)
    for name, a in zip(CL_NAMES, out):
        want, a = fx[f"mpc_cl_{name}"], a[0].numpy()
        if name == "solve_iters":
            np.testing.assert_array_equal(a, want)
        elif name == "costs":
            np.testing.assert_allclose(a, want, rtol=1e-8, atol=0)
        else:
            np.testing.assert_allclose(a, want, rtol=1e-6, atol=1e-8,
                                       err_msg=name)
    lb, ub = ctrl.params0.glob.s_lb.numpy(), ctrl.params0.glob.s_ub.numpy()
    u = out.controls[0].numpy()
    assert np.all(u >= lb - 1e-9) and np.all(u <= ub + 1e-9)


def test_contact_node_with_rk4(fx):
    """monkey_bar with RK4 nodes on the plain path (K1's plain version;
    tests/test_torch_rk4_contacts.py has the other contact cases): node
    derivatives at hang nodes 1 and 15 (the gripper's contact active) and
    at the free node 35 of the contact fixture's solution, against the JAX
    package's."""
    spec, params = _build(f"{FLAGSHIP}/trajectories/monkey_bar.yaml", 40)
    assert spec.integrator == P.RK4 and len(spec.contacts) == 1
    with np.load(os.path.join(FIXTURES, "torch_port_contacts.npz")) as z:
        xs, us = z["mb_xs"], z["mb_us"]
    nodes = fx["mb_nodes"]
    assert params.node.contact_active[nodes, 0].tolist() == [1.0, 1.0, 0.0]
    view = P.node_views(params.node, torch.as_tensor(nodes))
    d = P.node_calc_diff(spec, view, params.glob, t(xs[nodes]), t(us[nodes]))
    for name in d._fields:
        assert rel_err(fx[f"mb_cd_{name}"], getattr(d, name)) < TOL, name


@pytest.mark.parametrize("integrator", ["IntegratedActionModelEuler", RK4])
def test_convert_carries_the_integrator(integrator):
    """``from_trajectory`` takes the integrator's reference name as the JAX
    package's does, and ``convert.spec_from_jax`` carries it."""
    rel = "iris/trajectories/hover.yaml"
    jspec, _ = JP.from_trajectory(jspecs.load_trajectory(rel, yaml_dir=MISSIONS),
                                  dt_ms=60, use_squash=True,
                                  integrator=integrator)
    spec = convert.spec_from_jax(jspec)
    assert spec.integrator == jspec.integrator
    assert spec.integrator == (P.RK4 if integrator == RK4 else P.EULER)
    traj = port_config.load_trajectory(rel, yaml_dir=MISSIONS)
    built, _ = P.from_trajectory(traj, dt_ms=60, use_squash=True,
                                 integrator=integrator, device=CPU)
    assert dataclasses.replace(built, model=spec.model) == spec
