"""RK4 nodes on the contact missions: the PyTorch port against the JAX
package, float64 on the CPU (the kernels' plain versions).

The JAX values are keys of tests/fixtures/torch_port_rk4.npz (made by
``tools/make_torch_port_fixtures.py rk4``; no JAX function is compiled
here), each compared to 1e-9 relative to the output's largest entry:

- ``ecr4_*``: ``node_calc_diff`` of eagle_catch at dt 50 ms at its contact
  nodes 31 and 34 of the contact fixture's rough candidate (``ecr_*``),
  where the friction cone's barrier is active at the stage points;
- ``ecfp_*``: the FDDP forward pass of eagle_catch on a slippery surface
  (mu 0.1) at the contact fixture's solution for the 10 alphas, the
  cone's barrier active along the rollouts;
- ``mbfp_*``: the FDDP forward pass of monkey_bar at dt 100 ms (T = 18)
  for the 10 alphas, with the solver's own directions at its start and
  after three iterations (the gaps contracted);
- ``off_*``: the offline entry point with ``--integrator`` RK4 (iris
  hover at dt 60 ms; the contact missions take tens of seconds a solve
  here);
- ``mbit_*``: three FDDP iterations of monkey_bar at dt 100 ms, held to
  the same steps and, since these iterations turn a change of one unit in
  the last place of their operands into as large a change as their
  distance from JAX's (a test shows it), costs to 1e-7 and states and
  controls to 5e-5 of the largest entry, a few times that witness
  (measured on this CPU: 4.1e-8, 7.3e-6 and 5.0e-6 from JAX's; the
  witness 2.1e-8 and 1.7e-5).

monkey_bar hangs turned by pi about y from its state references, on the
rotation log's branch cut: there the sign of a state residual, and so of
Lx, Lu and Lxu, follows the sign of the quaternion's w at the RK4 stage
points, which round-off sets. The iterations start from ``default_init``
with every candidate state's base turned by 1e-3 rad about its y axis
(off the cut); a test shows the cut at the untouched start.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch import config as port_config
from eagle_mpc_tpu_torch import trajectory
from eagle_mpc_tpu_torch.ocp import costs as C
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.solvers import fddp

from torch_port_util import CPU, F64, FLAGSHIP, MISSIONS, rel_err, t

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
RK4 = "IntegratedActionModelRK4"
TOL = 1e-9
TURN = 1e-3   # rad, tools/make_torch_port_fixtures.py RK4_TURN
TIGHT_MU = 0.1   # tools/make_torch_port_fixtures.py TIGHT_MU


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(os.path.join(FIXTURES, "torch_port_rk4.npz")))


def build(mission, dt_ms, mu=None):
    """(spec, params at B = 1) of a mission with RK4 nodes, every friction
    cone's coefficient set to ``mu`` if given."""
    traj = port_config.load_trajectory(
        f"{FLAGSHIP}/trajectories/{mission}.yaml", yaml_dir=MISSIONS)
    if mu is not None:
        traj = dataclasses.replace(traj, stages=tuple(
            dataclasses.replace(st, costs=tuple(
                dataclasses.replace(c, mu=mu) if c.n_surf is not None else c
                for c in st.costs))
            for st in traj.stages))
    spec, params = P.from_trajectory(traj, dt_ms=dt_ms, use_squash=True,
                                     integrator=RK4, device=CPU)
    return spec, P.expand_params(params, 1)


@pytest.fixture(scope="module")
def monkey_bar_dt100():
    spec, pb = build("monkey_bar", 100)
    assert spec.integrator == P.RK4 and spec.T == 18 and spec.nc_rows == 3
    return spec, pb


def turned_start(spec, pb):
    """``default_init`` with every candidate state's base turned by TURN
    about its y axis."""
    xs0, us0 = fddp.default_init(spec, pb)
    turn = torch.zeros(spec.state.ndx, dtype=F64)
    turn[4] = TURN
    return spec.state.integrate(xs0, turn), us0


def test_node_calc_diff_at_an_active_cone_matches_jax(fx):
    """eagle_catch's contact nodes at a rough candidate: the cone's rows at
    every stage point come from that stage's forces, and the barrier is
    active at some of them, so its rows enter the Gauss-Newton terms."""
    spec, pb = build("eagle_catch", 50)
    with np.load(os.path.join(FIXTURES, "torch_port_contacts.npz")) as z:
        xs, us = t(z["ecr_xs"]), t(z["ecr_us"])
    nodes = fx["ecr4_nodes"].tolist()
    view = P.node_views(pb.node, (0, nodes))
    glob = P.map_params(lambda a: a.expand((len(nodes),) + a.shape[1:]),
                        pb.glob)
    d = P.node_calc_diff(spec, view, glob, xs[nodes], us[nodes])
    for name in d._fields:
        assert rel_err(fx[f"ecr4_cd_{name}"], getattr(d, name)) < TOL, name
    # the barrier: some stage point's cone rows lie outside their bounds
    k = next(i for i, s in enumerate(spec.slots) if s.kind == C.FRICTION_CONE)
    pts, _, _ = P._stage_points(spec, view, glob, xs[nodes], us[nodes])
    lb, ub = glob.lb[k], glob.ub[k]
    viol = [((r < lb) | (r > ub)).any().item() for r in (
        P._point_residuals(spec, view, x, us[nodes], False, f)[k]
        for _, x, f in pts)]
    assert any(viol)
    assert float(d.Lxu.abs().max()) > 0.0


def forward_pass(spec, pb, fx, key):
    """``fddp._forward_pass_multi`` (K2's plain version) at the fixture's
    ``<key>_*`` inputs for the 10 alphas: (xs_try, us_try, cost_try,
    diverged)."""
    settings = fddp.SolverSettings()
    B = fx[f"{key}_xs"].shape[0]
    params = P.expand_params(P.map_params(lambda a: a[0], pb), B)
    k, K, fs = (t(fx[f"{key}_{n}"]) for n in ("k", "K", "fs"))
    bp = fddp.BackwardPassData(k=k, K=K, Qu=k, Quuk=k, Vx=fs, Vxx=None,
                               ok=None)
    return fddp._forward_pass_multi(
        spec, settings, params, t(fx[f"{key}_xs"]), t(fx[f"{key}_us"]), bp,
        fs, torch.tensor(settings.alphas, dtype=F64),
        torch.as_tensor(fx[f"{key}_feasible"]), ddp=False, box=False)


def test_forward_pass_with_an_active_cone_matches_jax(fx):
    """K2's plain version on eagle_catch with RK4 nodes on a slippery
    surface (every cone's mu TIGHT_MU) at the contact fixture's solution
    for the 10 alphas (``ecfp_*``): the rollouts' states, controls and
    costs against JAX's, with the cone's barrier active at stage points of
    the compared rollouts, so each node's cost takes the cone's rows from
    every stage's own forces."""
    spec, pb = build("eagle_catch", 50, mu=TIGHT_MU)
    xs_try, us_try, cost_try, diverged = forward_pass(spec, pb, fx, "ecfp")
    assert np.array_equal(fx["ecfp_diverged"], diverged.numpy())
    ok = ~fx["ecfp_diverged"][0]
    assert ok.sum() >= 3
    for name, b in zip(("xs_try", "us_try", "cost_try"),
                       (xs_try, us_try, cost_try)):
        assert rel_err(fx[f"ecfp_{name}"][0, ok], b[0].numpy()[ok]) < TOL, name
    # the barrier: the cone's rows at some stage point of a compared
    # rollout lie outside their bounds where the cone is weighted
    n, T = int(ok.sum()), spec.T
    x = xs_try[0, ok][:, :T].reshape(n * T, -1)
    s = us_try[0, ok].reshape(n * T, -1)
    view = P.map_params(lambda a: a.reshape((n * T,) + a.shape[2:]),
                        P.running_views(P.map_params(
                            lambda a: a.expand((n,) + a.shape[1:]), pb.node),
                            T))
    glob = P.map_params(lambda a: a.expand((n * T,) + a.shape[1:]), pb.glob)
    k = next(i for i, sl in enumerate(spec.slots)
             if sl.kind == C.FRICTION_CONE)
    on = view.weight[:, k] * view.active[:, k] != 0
    pts, _, _ = P._stage_points(spec, view, glob, x, s)
    hit = [on & ((r < glob.lb[k]) | (r > glob.ub[k])).any(-1) for r in (
        P._point_residuals(spec, view, xi, s, False, f)[k] for _, xi, f in pts)]
    assert bool(torch.stack(hit).any())


def test_default_init_sits_on_the_branch_cut(monkey_bar_dt100):
    """At monkey_bar's untouched start the node derivatives' gradients
    follow the sign of the quaternion's w: +-1e-16 on it flips Lu's largest
    entries (and moves Lx), while the dynamics Jacobians and Luu stay; 1e-3
    rad off the cut the same change moves nothing past round-off."""
    spec, pb = monkey_bar_dt100

    def moved_by_w(xs, us):
        got = []
        for w in (1e-16, -1e-16):
            x = xs.clone()
            x[..., 6] = x[..., 6] + w
            got.append(P.calc_diff_all(spec, pb, x, us)[0])
        return {n: rel_err(getattr(got[0], n).numpy(), getattr(got[1], n))
                for n in ("Fx", "Fu", "Luu", "Lu", "Lx")}

    xs0, us0 = fddp.default_init(spec, pb)
    assert xs0[0, 0, 3:7].tolist() == [0.0, 1.0, 0.0, 0.0]
    on = moved_by_w(xs0, us0)
    assert on["Lu"] > 1.0 and on["Lx"] > 1e-6
    assert max(on["Fx"], on["Fu"], on["Luu"]) < 1e-9
    off = moved_by_w(*turned_start(spec, pb))
    assert max(off.values()) < 1e-11


def test_forward_pass_matches_jax(fx, monkey_bar_dt100):
    """``fddp._forward_pass_multi`` (K2's plain version) on monkey_bar with
    RK4 nodes for the 10 alphas, both elements infeasible: the rollouts'
    states, controls and costs (each node's the quadrature over its four
    constrained stage points) and the diverged lanes (the larger alphas:
    the stiff hang), against JAX's."""
    spec, pb = monkey_bar_dt100
    got = forward_pass(spec, pb, fx, "mbfp")
    diverged = fx["mbfp_diverged"]
    assert np.array_equal(diverged, got[3].numpy())
    ok = ~diverged
    assert ok[0].sum() >= 3 and ok[1].sum() >= 3
    for name, b in zip(("xs_try", "us_try", "cost_try"), got[:3]):
        assert rel_err(fx[f"mbfp_{name}"][ok], b.numpy()[ok]) < TOL, name


def nudged(a, g):
    """``a`` times 1 + 1e-16 N(0, 1) (about one unit in the last place) if it
    is a floating tensor, else ``a``."""
    if not torch.is_floating_point(a):
        return a
    return a * (1 + 1e-16 * torch.randn(a.shape, generator=g, dtype=a.dtype))


@pytest.fixture(scope="module")
def iterations(monkey_bar_dt100):
    """Three FDDP iterations from the turned start, and the same with every
    operand (the params, the start's states and controls) nudged by about
    one unit in the last place (seeded): (result, trace) each."""
    spec, pb = monkey_bar_dt100
    xs0, us0 = turned_start(spec, pb)
    g = torch.Generator().manual_seed(0)
    out = []
    for p, x, u in ((pb, xs0, us0), (P.map_params(lambda a: nudged(a, g), pb),
                                     nudged(xs0, g), nudged(us0, g))):
        r = fddp.solve_fddp(spec, fddp.SolverSettings(record_trace=True), p,
                            x, u, 3, 1e-9)
        out.append((r, fddp.IterTrace(*(a[0].numpy() for a in r.trace))))
    return out


def test_three_iterations_match_jax(fx, iterations):
    """``fddp.solve_fddp`` from the turned start, three iterations: the
    same accepted steps and phases; costs, states and controls within the
    module docstring's tolerances."""
    r, tr = iterations[0]
    for name in ("iters", "feasible", "failed"):
        assert getattr(r, name)[0].item() == fx[f"mbit_{name}"].item(), name
    for name in ("accepted", "phase", "steplength"):
        np.testing.assert_array_equal(getattr(tr, name),
                                      fx[f"mbit_trace_{name}"], err_msg=name)
    assert rel_err(fx["mbit_trace_cost"], tr.cost) < 1e-7
    assert rel_err(fx["mbit_cost"], r.cost[0]) < 1e-7
    for name in ("xs", "us"):
        assert rel_err(fx[f"mbit_{name}"], getattr(r, name)[0]) < 5e-5, name


def test_three_iterations_amplify_round_off(iterations):
    """Why the iterations are not held to 1e-9: every operand nudged by
    about one unit in the last place takes the same steps and moves the
    states by as much as they lie from JAX's (1.7e-5 of their largest entry
    measured, against 7.3e-6) and the costs by 2.1e-8 (against 4.1e-8)."""
    (r, tr), (r2, tr2) = iterations
    np.testing.assert_array_equal(tr.steplength, tr2.steplength)
    assert rel_err(r.xs[0].numpy(), r2.xs[0]) > 2e-6
    assert rel_err(tr.cost, tr2.cost) > 5e-9


def test_entry_point_takes_the_integrator(fx, tmp_path, capsys):
    """``python3 -m eagle_mpc_tpu_torch.trajectory ... --integrator
    IntegratedActionModelRK4 --cpu`` solves with RK4 nodes: iris hover at
    dt 60 as the JAX package's RK4 solve (``off_*``)."""
    out = tmp_path / "sol.npz"
    rc = trajectory.main(["iris", "hover", "--dt", "60", "--maxiter", "100",
                          "--integrator", RK4, "--cpu", "--f64",
                          "--out", str(out)])
    assert rc == 0 and "1 of 1" in capsys.readouterr().out
    with np.load(out) as z:
        assert int(z["iters"]) == int(fx["off_iters"])
        np.testing.assert_allclose(z["cost"], fx["off_cost"], rtol=1e-8)
