"""The PyTorch port's flagship tick as a whole, against the JAX package's
fixture (tests/fixtures/torch_port_flagship.npz, made by
tools/make_torch_port_fixtures.py), float64 on the CPU at B=2:

- warm start: ``solve_fixed(depth=4, polish="fixed")`` with the default
  settings (two homotopy stages) from cold candidates;
- tick: ``update_problem`` + ``solve_fixed(depth=2, n_alphas=10,
  polish="while_fixed", polish_maxiter=1)`` at convergence_init=1e-3 +
  ``AerialSimulator.step``; element 1 needs the DDP polish.

Equal feasible / iters / failed, cost to rtol 1e-8, xs, us and x_next to
rtol 1e-6 / atol 1e-8 (the tolerances of tests/test_node_pallas.py).
Compiling the JAX tick takes about a minute on a CPU, hence the fixture.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.sim import AerialSimulator
from eagle_mpc_tpu_torch.solvers import sbfddp

from torch_port_util import CPU, F64, FIXTURE, controllers, load_port, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    tc = controllers()[1]
    mp = load_port("hexacopter370_flying_arm_3")[1]
    sim = AerialSimulator.from_platform(mp.model, mp.platform, 2, device=CPU,
                                        dtype=F64)
    return tc, sim, np.load(FIXTURE)


def _check(fx, prefix, res, extra=()):
    for name in ("feasible", "iters", "failed"):
        np.testing.assert_array_equal(
            getattr(res, name).numpy().astype(fx[f"{prefix}_{name}"].dtype),
            fx[f"{prefix}_{name}"], err_msg=name)
    np.testing.assert_allclose(res.cost.numpy(), fx[f"{prefix}_cost"],
                               rtol=1e-8)
    for name, a in (("xs", res.xs), ("us", res.us),
                    ("us_squash", res.us_squash)) + tuple(extra):
        np.testing.assert_allclose(a.numpy(), fx[f"{prefix}_{name}"],
                                   rtol=1e-6, atol=1e-8, err_msg=name)


def test_warm_start_matches_jax(setup):
    tc, _, fx = setup
    base = P.expand_params(tc.params0, 2)._replace(x0=t(fx["x0"]))
    res = sbfddp.solve_fixed(tc.spec, tc.update_problem(t(fx["warm_t"]), base),
                             t(fx["warm_xs_in"]), t(fx["warm_us_in"]), depth=4,
                             polish="fixed")
    assert tc.solver_settings().n_stages == 1
    assert sbfddp.SbFddpSettings().n_stages == 2
    _check(fx, "warm", res)


def test_tick_matches_jax(setup):
    tc, sim, fx = setup
    x0 = t(fx["x0"])
    base = P.expand_params(tc.params0, 2)._replace(x0=x0)
    res = sbfddp.solve_fixed(tc.spec, tc.update_problem(t(fx["tick_t"]), base),
                             t(fx["tick_xs_in"]), t(fx["tick_us_in"]),
                             depth=tc.iters, settings=tc.solver_settings(),
                             n_alphas=10, polish="while_fixed", polish_maxiter=1)
    x_next = sim.step(x0, res.us_squash[:, 0])
    assert fx["tick_iters"].tolist() == [2, 3]   # the polish ran for element 1
    _check(fx, "tick", res, (("x_next", x_next),))


def test_port_runs_without_jax():
    """Importing the port, building the flagship controller and running one
    CPU closed-loop tick at B=2 (``run_closed_loop``: the while-loop route
    of ``MpcAbstract.solve``), the task-activated controller's update, the
    plant's rollout, ``State``'s constructors, ``utils``, the closed loop's
    entry point module, and the offline path (the entry point's module,
    ``from_trajectory``, one iteration of each stage of ``sbfddp.solve``
    and of Box-FDDP on iris hover) never imports jax, the JAX package or
    ``tools``."""
    code = """
import sys, numpy as np, torch
torch.set_num_threads(1)
from eagle_mpc_tpu_torch.config import load_mpc_params, load_ref, load_trajectory
from eagle_mpc_tpu_torch.mpc import CarrotMpc, TaskActivatedCarrotMpc, run_closed_loop
from eagle_mpc_tpu_torch.mpc import __main__
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.sim import AerialSimulator
from eagle_mpc_tpu_torch.solvers import fddp
from eagle_mpc_tpu_torch.utils import log, tools
R = "hexacopter370_flying_arm_3"
cpu, f64 = torch.device("cpu"), torch.float64
traj = load_trajectory(f"{R}/trajectories/displacement.yaml", yaml_dir="missions")
mp = load_mpc_params(f"{R}/mpc/mpc.yaml", yaml_dir="missions")
ref, _ = load_ref(R, "displacement", 30, traj=traj)
ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref, dt_ref=30,
                 device=cpu, dtype=f64)
sim = AerialSimulator.from_platform(mp.model, mp.platform, 2, device=cpu,
                                    dtype=f64)
x0 = torch.as_tensor(ref[:2], dtype=f64)
T = ctrl.spec.T
out = run_closed_loop(ctrl, sim, x0, torch.as_tensor(ref[:T + 1]).expand(2, -1, -1),
                      torch.zeros(2, T, ctrl.spec.nu, dtype=f64), n_steps=1,
                      dt_sim_ms=2.0)
assert torch.isfinite(out.states).all() and torch.isfinite(out.costs).all()
task = TaskActivatedCarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref,
                              dt_ref=30, device=cpu, dtype=f64)
task.update_problem(torch.zeros(2, dtype=f64), P.expand_params(task.params0, 2))
x = ctrl.state.normalize(ctrl.state.rand(np.random.default_rng(0))[None])
assert sim.rollout(x, out.controls[:1]).shape == (1, 2, ctrl.state.nx)
log.debug(tools.mission_errors(out.states[0].numpy(), ref[:2], mp.model.nq))
from eagle_mpc_tpu_torch import trajectory
from eagle_mpc_tpu_torch.solvers import sbfddp
hover = load_trajectory("iris/trajectories/hover.yaml", yaml_dir="missions")
for squash in (True, False):
    spec, p = P.from_trajectory(hover, dt_ms=60, use_squash=squash,
                                integrator="IntegratedActionModelEuler",
                                device=torch.device("cpu"))
    p = P.expand_params(p, 1)
    if squash:
        r = sbfddp.solve(spec, p, maxiter=1)
    else:
        r = fddp.solve_box_fddp(spec, fddp.SolverSettings(), p,
                                *fddp.default_init(spec, p), 1, 1e-9)
    assert torch.isfinite(r.cost).all()
bad = sorted(m for m in sys.modules
             if m in ("jax", "eagle_mpc_tpu", "tools")
             or m.startswith(("jax.", "eagle_mpc_tpu.", "tools.")))
assert not bad, f"the port imported {bad}"
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """Each kernel against its plain version on the card, float64, at the
    tick state of the carrot fixture and of the weighted one (whose spec has
    every frame kind: K1's frame columns, K2's frame costs); runs where
    CUDA is present; needs no jax, so it also runs with ``--noconftest`` on
    a machine without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels "
                    "on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke

    dev = torch.device("cuda")
    for controller in ("weighted", "carrot"):
        fx = np.load(os.path.join(ROOT, "tests", "fixtures",
                                  chip_smoke.FIXTURES[controller]))
        ctrl = chip_smoke.flagship(dev, torch.float64, controller)[0]
        state = (float(fx["tick_t"][0]), torch.as_tensor(fx["x0"]),
                 torch.as_tensor(fx["tick_xs_in"]),
                 torch.as_tensor(fx["tick_us_in"]))
        params, xs, us, feas = chip_smoke.parity_inputs(ctrl, state, dev,
                                                        torch.float64)
        calls = chip_smoke.kernel_calls(ctrl, params, xs, us, feas, reg=1e-2)
        for name, (kern, plain, _, _) in calls.items():
            got, want = kern(), plain()
            if name == "alpha_rollout":
                lanes = chip_smoke._healthy_lanes(want)
                assert torch.equal(lanes, chip_smoke._healthy_lanes(got))
                got, want = [g[lanes] for g in got], [w[lanes] for w in want]
            for w, g in zip(want, got):
                assert chip_smoke._err(w, g)[1] < chip_smoke.PARITY_RTOL, \
                    (controller, name)
    # K3 on a ragged batch and with indefinite Quu, at the state tiled to 12
    tile = tuple(torch.as_tensor(np.concatenate([np.asarray(a)] * 6))
                 for a in (fx["x0"], fx["tick_xs_in"], fx["tick_us_in"]))
    params, xs, us, feas = chip_smoke.parity_inputs(
        ctrl, (state[0],) + tile, dev, torch.float64)
    bargs = chip_smoke.kernel_calls(ctrl, params, xs, us, feas,
                                    reg=1e-2)["riccati_backward"][2]
    cases = chip_smoke.riccati_cases(bargs, n_ragged=11, every=5)
    assert cases["indefinite"][2] <= 10
    for name, (_, rel, _, _) in cases.items():
        assert rel < chip_smoke.PARITY_RTOL, name


@pytest.mark.cuda
def test_riccati_escalation_matches_plain_on_cuda():
    """K3's escalating entry on the card, float64 and float32, at the carrot
    fixture's tick state tiled to 12 (``chip_smoke.riccati_escalation_cases``:
    three scenarios of each kind, as given, retrying, failing up to reg_max,
    non-finite derivatives): passes, final regularizations and failures
    exactly the plain version's, the f64 values within the K3 gate, and the
    scenarios that did not retry bit for bit the one-pass kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels "
                    "on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke

    dev = torch.device("cuda")
    fx = np.load(os.path.join(ROOT, "tests", "fixtures",
                              chip_smoke.FIXTURES["carrot"]))
    tile = tuple(torch.as_tensor(np.concatenate([np.asarray(a)] * 6))
                 for a in (fx["x0"], fx["tick_xs_in"], fx["tick_us_in"]))
    for dtype in (torch.float64, torch.float32):
        ctrl = chip_smoke.flagship(dev, dtype, "carrot")[0]
        params, xs, us, feas = chip_smoke.parity_inputs(
            ctrl, (float(fx["tick_t"][0]),) + tile, dev, dtype)
        bargs = chip_smoke.kernel_calls(ctrl, params, xs, us, feas,
                                        reg=1e-2)["riccati_backward"][2]
        out = chip_smoke.riccati_escalation_cases(bargs)
        assert out["bitwise"] >= 6, dtype
        if dtype == torch.float64:
            assert out["max_rel"] < chip_smoke.PARITY_RTOL


@pytest.mark.cuda
def test_offline_kernels_match_plain_on_cuda():
    """The offline path on the card, float64: a short iris hover
    ``sbfddp.solve`` through the kernels against its plain run on the CPU
    (the same iterations and feasibility, states to 1e-8), and K1 and K2
    with the box clip against their plain versions at the box spec (no
    squash, no arm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels "
                    "on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from eagle_mpc_tpu_torch.solvers import fddp

    dev = torch.device("cuda")
    res = {}
    for d in (dev, CPU):
        spec, params = chip_smoke.offline_problem(d, F64, "iris", "hover", 60)
        res[d.type] = sbfddp.solve(spec, params, maxiter=60)
    for name in ("iters", "feasible", "failed"):
        assert torch.equal(getattr(res["cuda"], name).cpu(),
                           getattr(res["cpu"], name)), name
    np.testing.assert_allclose(res["cuda"].xs.cpu().numpy(),
                               res["cpu"].xs.numpy(), rtol=0, atol=1e-8)
    spec, params = chip_smoke.offline_problem(dev, F64, "iris", "hover", 40,
                                              use_squash=False)
    xs, us = fddp.default_init(spec, params)
    r = fddp.solve_fixed(spec, fddp.SolverSettings(), params, xs, us, 3, 1e-9,
                         box=True)
    stats = chip_smoke._offline_parity(
        spec, params, (r.xs, r.us), "iris box", box=True,
        kernels=("node_linearization", "alpha_rollout"))
    assert set(stats) == {"node_linearization", "alpha_rollout"}
