"""The PyTorch port's closed-loop layer against the JAX package, float64 on
the CPU: ``run_closed_loop`` through both routes of ``MpcAbstract.solve``,
``sbfddp.solve_fixed``'s while-loop polish, ``TaskActivatedCarrotMpc``,
``AerialSimulator.rollout``, ``State.zero/rand/normalize``, the final-cost
fallback, slot-less specs, node derivatives at quaternions of norm
1 +- 1e-7, ``utils.tools`` and the entry point ``python3 -m
eagle_mpc_tpu_torch.mpc``.

The JAX values are tests/fixtures/torch_port_closed_loop.npz
(``JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py
closed_loop``); nothing here jit-compiles a JAX function. Solves: equal
iterations, states and controls to rtol 1e-6 / atol 1e-8, costs to rtol
1e-8 (the tolerances of tests/test_torch_slice.py); evaluations: 1e-10
relative to each field's largest entry (tests/test_torch_node.py's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_mpc_tpu.dynamics.state import State as JaxState
from eagle_mpc_tpu.mpc import CarrotMpc as JaxCarrot
from eagle_mpc_tpu.utils import tools as jax_tools
from eagle_mpc_tpu_torch.dynamics.state import State
from eagle_mpc_tpu_torch.mpc import (CarrotMpc, TaskActivatedCarrotMpc,
                                     run_closed_loop)
from eagle_mpc_tpu_torch.mpc import __main__ as mpc_main
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.sim import AerialSimulator
from eagle_mpc_tpu_torch.solvers import fddp, sbfddp
from eagle_mpc_tpu_torch.utils import tools

from torch_port_util import (CL_FIXTURE, CPU, F64, FLAGSHIP, FIXTURE,
                             flagship_ref, load, load_port, rel_err, t)
TOL = 1e-10
CL_NAMES = ("states", "controls", "solve_iters", "costs", "xs", "us")


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(CL_FIXTURE))


@pytest.fixture(scope="module")
def iris():
    """(trajectory, mpc params) of iris hover, the port's."""
    return load_port("iris", "hover")


def _warm(T, xs, us):
    """The hold-padded warm start of examples/mpc.py, at B = 1."""
    pad = max(0, T + 1 - xs.shape[0])
    xs_w = np.vstack([xs, np.tile(xs[-1], (pad, 1))])[:T + 1]
    us_w = np.vstack([us, np.tile(us[-1], (pad, 1))])[:T]
    return t(xs_w[None]), t(us_w[None])


def _close(got, want, name, rtol=1e-6, atol=1e-8):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("route", ["while", "fixed"])
def test_closed_loop_matches_jax(fx, iris, route):
    """3 ticks of iris hover's CarrotMpc at a 10 ms plant from the JAX
    offline solve (tests/test_mpc.py's ``iris_setup``), with ``fixed``
    False (while-loop SbFDDP) and True (fixed depth, "while" polish)."""
    traj, mp = iris
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=fx["iris_xs"],
                     dt_ref=40, device=CPU, dtype=F64)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, 10, device=CPU,
                                        dtype=F64)
    xs_w, us_w = _warm(ctrl.spec.T, fx["iris_xs"], fx["iris_us"])
    out = run_closed_loop(ctrl, sim, t(fx["iris_xs"][:1]), xs_w, us_w,
                          n_steps=3, dt_sim_ms=10.0, fixed=route == "fixed")
    for name, a in zip(CL_NAMES, out):
        want = fx[f"cl_{route}_{name}"]
        a = a[0].numpy()
        if name == "solve_iters":
            np.testing.assert_array_equal(a, want)
        elif name == "costs":
            _close(a, want, name, rtol=1e-8, atol=0)
        else:
            _close(a, want, name)


def test_while_polish_matches_jax(fx):
    """``solve_fixed(polish="while")``, the default, from the flagship tick
    fixture's rough element: the while-loop DDP polish runs for it."""
    traj, mp = load_port(FLAGSHIP)
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=flagship_ref(traj),
                     dt_ref=30, device=CPU, dtype=F64)
    tick = np.load(FIXTURE)
    params = ctrl.update_problem(
        t(tick["tick_t"][1:]),
        P.expand_params(ctrl.params0, 1)._replace(x0=t(tick["x0"][1:])))
    r = sbfddp.solve_fixed(ctrl.spec, params, t(tick["tick_xs_in"][1:]),
                           t(tick["tick_us_in"][1:]), depth=2,
                           settings=ctrl.solver_settings())
    assert int(fx["pw_iters"]) > 2          # the polish ran
    for name in ("iters", "feasible", "failed"):
        np.testing.assert_array_equal(getattr(r, name)[0].numpy(),
                                      fx[f"pw_{name}"], err_msg=name)
    _close(r.cost[0].numpy(), fx["pw_cost"], "cost", rtol=1e-8, atol=0)
    for name in ("xs", "us", "us_squash"):
        _close(getattr(r, name)[0].numpy(), fx[f"pw_{name}"], name)
    with pytest.raises(ValueError, match="while|while_fixed|fixed|none"):
        sbfddp.solve_fixed(ctrl.spec, params, t(tick["tick_xs_in"][1:]),
                           t(tick["tick_us_in"][1:]), polish="ladder")


def test_task_activated_update_matches_jax(fx, iris):
    """``TaskActivatedCarrotMpc.update_problem`` at 4 times around iris
    hover's stage change (1100 ms), batched: the mission slots' activity,
    the terminal carrot's and its reference."""
    traj, mp = iris
    ctrl = TaskActivatedCarrotMpc(mpc_params=mp, trajectory=traj,
                                  state_ref=fx["iris_xs"], dt_ref=40,
                                  device=CPU, dtype=F64)
    names = [s.name for s in ctrl.spec.slots]
    assert names[-2:] == ["task_carrot", "barrier"]
    n = len(fx["task_t"])
    got = ctrl.update_problem(t(fx["task_t"]), P.expand_params(ctrl.params0, n))
    K = ctrl._n_mission_slots
    np.testing.assert_array_equal(got.node.active.numpy(), fx["task_active"])
    _close(got.node.refs[K].numpy(), fx["task_ref"], "ref", rtol=0, atol=1e-12)
    assert fx["task_active"][:, -1, K].tolist() == [1.0, 0.0, 0.0, 0.0]


def test_state_and_rollout_match_jax(fx):
    """``State.zero`` / ``rand`` (seed 0) / ``normalize`` and 5 steps of
    ``AerialSimulator.rollout`` (flagship, 2 ms) from the random state."""
    mp = load_port(FLAGSHIP)[1]
    st, jst = State(mp.model.nq, mp.model.nv), JaxState(mp.model.nq, mp.model.nv)
    np.testing.assert_array_equal(st.zero().numpy(), np.asarray(jst.zero()))
    x = st.rand(np.random.default_rng(0))
    np.testing.assert_array_equal(x.numpy(), fx["rand_x"])
    y = fx["rand_x"].copy()
    y[3:7] *= 1.5
    np.testing.assert_allclose(st.normalize(t(y)).numpy(),
                               np.asarray(jst.normalize(jnp.asarray(y))), rtol=0,
                               atol=1e-15)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, 2, device=CPU,
                                        dtype=F64)
    xs = sim.rollout(x[None], t(fx["roll_u"])[None])
    assert xs.shape == (1, 6, mp.model.nx)
    _close(xs[0].numpy(), fx["roll_xs"], "rollout", rtol=0, atol=1e-12)


def test_solve_routes_and_properties(iris):
    """``solve`` refuses a schedule on the fixed route; ``solver_type`` and
    ``state`` are the JAX controller's."""
    traj, mp = iris
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj,
                     state_ref=np.tile(traj.initial_state, (3, 1)), dt_ref=40,
                     device=CPU, dtype=F64)
    jtraj, jmp = load("iris", "hover")
    jc = JaxCarrot(mpc_params=jmp, trajectory=jtraj,
                   state_ref=np.tile(jtraj.initial_state, (3, 1)), dt_ref=40)
    assert ctrl.solver_type == jc.solver_type == "SolverSbFDDP"
    assert tuple(ctrl.state) == tuple(jc.state)
    params = P.expand_params(ctrl.params0, 1)
    xs, us = fddp.default_init(ctrl.spec, params)
    schedule = sbfddp.HomotopySchedule.from_settings(ctrl.solver_settings(), 2)
    with pytest.raises(ValueError, match="schedule"):
        ctrl.solve(params, xs, us, fixed=True, schedule=schedule)


def test_final_cost_fallback(fx):
    """``fddp.solve_fixed`` on iris hover (dt 60) with budgets (0, 1): with
    the fallback (the default) the zero-budget element gets
    ``problem.total_cost`` of its candidate, as JAX's; without, inf. The
    other element's iteration is the same either way."""
    traj = load_port("iris", "hover")[0]
    spec, params = P.from_trajectory(traj, dt_ms=60, use_squash=True,
                                     integrator="IntegratedActionModelEuler",
                                     device=CPU)
    pb = P.expand_params(params, 2)
    xs, us = fddp.default_init(spec, pb)
    budget = torch.tensor([0, 1])
    solve = lambda fb: fddp.solve_fixed(
        spec, fddp.SolverSettings(), pb, xs, us, 1, 1e-9, maxiter=budget,
        final_cost_fallback=fb)
    on, off = solve(True), solve(False)
    assert on.iters.tolist() == [0, 1]
    _close(on.cost.numpy(), [float(fx["fb_cost0"]), float(fx["fb_cost1"])],
           "cost", rtol=1e-8, atol=0)
    assert float(on.cost[0]) == float(P.total_cost(spec, pb, xs, us)[0])
    assert torch.isinf(off.cost[0]) and float(off.cost[1]) == float(on.cost[1])


def test_slotless_spec_matches_jax(fx):
    """A spec with no cost slot (iris hover at dt 40 without the squash,
    its slots removed): node derivatives and ``total_cost`` against the
    JAX package's XLA path; the kernels' zero-slot launch is held to these
    plain versions on the card (chip_smoke.py)."""
    traj = load_port("iris", "hover")[0]
    spec, params = P.from_trajectory(traj, dt_ms=40, use_squash=False,
                                     integrator="IntegratedActionModelEuler",
                                     device=CPU)
    node, glob = params.node, params.glob
    spec = dataclasses.replace(spec, slots=())
    params = P.expand_params(params._replace(
        node=node._replace(weight=node.weight[:, :0], active=node.active[:, :0],
                           refs=()),
        glob=glob._replace(act_w=(), lb=(), ub=())), 1)
    xs, us = t(fx["sl_xs"][None]), t(fx["sl_us"][None])
    d, term = P.calc_diff_all(spec, params, xs, us)
    for name in d._fields:
        assert rel_err(fx[f"sl_{name}"], getattr(d, name)[0]) < TOL, name
    for name, a in zip(("cost", "Lx", "Lxx"), term):
        assert rel_err(fx[f"sl_term_{name}"], a[0]) < TOL, name
    assert float(P.total_cost(spec, params, xs, us)[0]) == float(
        fx["sl_total_cost"]) == 0.0


def test_node_derivatives_off_unit_quaternion(fx):
    """The plain node derivatives at the flagship carrot candidates with
    every quaternion's norm 1 + 1e-7 (element 0) or 1 - 1e-7 (element 1),
    as a state born in float32 has it, against the JAX package's XLA path
    (the states the kernel's f64 parity is printed at on the card)."""
    traj, mp = load_port(FLAGSHIP)
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=flagship_ref(traj),
                     dt_ref=30, device=CPU, dtype=F64)
    xs = fx["qn_xs"]
    norm = np.linalg.norm(xs[..., 3:7], axis=-1)
    np.testing.assert_allclose(norm[0], 1 + 1e-7, rtol=1e-15)
    np.testing.assert_allclose(norm[1], 1 - 1e-7, rtol=1e-15)
    params = ctrl.update_problem(
        t(fx["qn_t"]), P.expand_params(ctrl.params0, 2)._replace(x0=t(xs[:, 0])))
    d, term = P.calc_diff_all(ctrl.spec, params, t(xs), t(fx["qn_us"]))
    for name in d._fields:
        assert rel_err(fx[f"qn_{name}"], getattr(d, name)) < TOL, name
    for name, a in zip(("cost", "Lx", "Lxx"), term):
        assert rel_err(fx[f"qn_term_{name}"], a) < TOL, name


def test_tools_match_jax(tmp_path):
    """``utils.tools`` against the JAX package's on the same numpy inputs,
    and the log file's round trip."""
    traj, mp = load_port(FLAGSHIP)
    jmp = load(FLAGSHIP)[1]
    rng = np.random.default_rng(6)
    thrust = rng.uniform(-1.0, 10.0, size=(5, mp.platform.n_rotors))
    np.testing.assert_allclose(tools.thrust_to_speed(thrust, mp.platform),
                               jax_tools.thrust_to_speed(thrust, jmp.platform),
                               rtol=1e-15)
    np.testing.assert_allclose(
        tools.thrust_to_speed_normalized(thrust, mp.platform),
        jax_tools.thrust_to_speed_normalized(thrust, jmp.platform), rtol=1e-15)
    st = State(mp.model.nq, mp.model.nv)
    xs = np.stack([st.rand(rng).numpy() for _ in range(4)])
    refs = np.stack([st.rand(rng).numpy() for _ in range(4)])
    np.testing.assert_allclose(
        tools.mission_errors(xs, refs, mp.model.nq),
        np.asarray(jax_tools.mission_errors(xs, refs, mp.model.nq)),
        rtol=1e-12, atol=1e-14)
    path = str(tmp_path / "log.pkl")
    tools.save_logfile(path, xs, refs, dt=0.002, iters=[1, 2],
                       extras={"robot": FLAGSHIP})
    log = tools.load_logfile(path)
    np.testing.assert_array_equal(log["xs"], xs)
    assert log["us_squash"] is None and log["robot"] == FLAGSHIP
    assert log["iters"].tolist() == [1, 2] and log["dt"] == 0.002


def test_entry_point_runs_on_the_cpu(capsys):
    """``python3 -m eagle_mpc_tpu_torch.mpc`` on the CPU: iris hover, the
    offline solve at dt 100 ms, then 2 ticks of a 20 ms plant."""
    assert mpc_main.main(["iris", "hover", "--cpu", "--f64", "--dt", "100",
                          "--dt-sim", "20", "--horizon-factor", "0.04"]) == 0
    err = capsys.readouterr().err
    assert "offline solve: iters=" in err and "feasible=True" in err
    assert "(2 ticks)" in err and "tracking error: mean" in err
