"""The PyTorch port's serving layer against the JAX package, float64 on the
CPU: the served tick (``mpc.graph.serving_tick``: ``update_problem``, the
fixed-depth solve, the 2 ms plant step, written back into its buffers) on
iris hover with ``mpc.yaml`` cut to the fixture's knots, B=2, 3 chained
ticks; its sync-free route (what a CUDA graph captures) against the eager
route, bit for bit, and against the JAX package's ``one_tick`` of
tools/serving_bench.py (tests/fixtures/torch_port_serving.npz, ``iris_*``;
``JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py serving``)
with the closed loop's tolerances; the bounded escalation and the masked
polish; the tick with every host read made to raise; the real-time entry
point's ``--smoke``; the serving bench's functions; and the new modules'
imports. Nothing here jit-compiles a JAX function."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eagle_mpc_tpu_torch import serving_bench as sb
from eagle_mpc_tpu_torch.config import load_ref
from eagle_mpc_tpu_torch.mpc import CarrotMpc
from eagle_mpc_tpu_torch.mpc import graph as G
from eagle_mpc_tpu_torch.mpc.carrot import CONTROL_REG
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.ops import riccati_cuda
from eagle_mpc_tpu_torch.sim import AerialSimulator
from eagle_mpc_tpu_torch.solvers import fddp, sbfddp

from torch_port_util import CPU, F64, load_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_serving.npz")
TICKS = 3
SETTINGS = sbfddp.SbFddpSettings(convergence_init=1e-3,
                                 solver=fddp.SolverSettings())
FIELDS = ("x", "xs", "us", "u0", "cost", "iters", "feasible")


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def iris(fx):
    """(controller, plant) of iris hover with the fixture's horizon, on the
    synthetic reference at dt 20 ms."""
    traj, mp = load_port("iris", "hover")
    mp = dataclasses.replace(mp, knots=int(fx["iris_knots"]))
    ref, kind = load_ref("iris", "hover", 20, traj=traj)
    assert kind == "synthetic"
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref,
                     dt_ref=20, device=CPU, dtype=F64)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, 2.0,
                                        device=CPU, dtype=F64)
    return ctrl, sim


def _start(fx):
    t = lambda k: torch.as_tensor(fx[f"iris_{k}"], dtype=F64)
    return G.make_buffers(float(fx["iris_t0"]), t("x0"), t("xs0"), t("us0"))


def _raise(*args, **kwargs):
    raise RuntimeError("a host read in the sync-free tick")


def _refuse_host_data(make):
    """``make`` (``torch.tensor``, ``torch.as_tensor``) refusing data that is
    not already a tensor: on a card that data would be a pageable copy."""
    def made(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise RuntimeError("a tensor made from host data in the "
                               "sync-free tick")
        return make(data, *args, **kwargs)
    return made


def _chain(ctrl, sim, buf, sync_free):
    tick = G.serving_tick(ctrl, sim, SETTINGS, 2.0, buf, sync_free=sync_free)
    rows = []
    for _ in range(TICKS):
        o = tick()
        rows.append(dict(x=buf.x.clone(), xs=buf.xs.clone(),
                         us=buf.us.clone(), u0=o.u0, cost=o.cost,
                         iters=o.iters, feasible=o.feasible))
    return rows


@pytest.fixture(scope="module")
def chains(fx, iris):
    """The 3 chained ticks on the eager route, then on the sync-free route
    with ``Tensor.__bool__``, ``.item``, ``.tolist``, ``.cpu`` and
    ``.numpy`` made to raise, and ``torch.tensor``, ``torch.as_tensor``
    and ``torch.from_numpy`` refusing host data."""
    ctrl, sim = iris
    eager = _chain(ctrl, sim, _start(fx), False)
    buf = _start(fx)
    mp = pytest.MonkeyPatch()
    for name in ("__bool__", "item", "tolist", "cpu", "numpy"):
        mp.setattr(torch.Tensor, name, _raise)
    for name in ("tensor", "as_tensor"):
        mp.setattr(torch, name, _refuse_host_data(getattr(torch, name)))
    mp.setattr(torch, "from_numpy", _raise)
    try:
        free = _chain(ctrl, sim, buf, True)
    finally:
        mp.undo()
    return eager, free


def test_sync_free_equals_eager_bitwise(chains):
    """(a) every output of every tick, iterations included, bit for bit;
    the first tick's polish runs for the rough element."""
    eager, free = chains
    for k, (e, f) in enumerate(zip(eager, free)):
        for n in FIELDS:
            assert torch.equal(e[n], f[n]), f"tick {k} {n}"
    assert int(eager[0]["iters"][1]) > 2


def test_ticks_match_jax(fx, chains):
    """(b) both routes against the JAX package's chained ``one_tick``:
    iterations and feasibility exact, states and controls to rtol 1e-6 /
    atol 1e-8, costs to rtol 1e-8."""
    for rows in chains:
        for n in FIELDS:
            got = torch.stack([r[n] for r in rows], dim=1).numpy()
            want = fx[f"iris_{n}"]
            if n in ("iters", "feasible"):
                np.testing.assert_array_equal(got.astype(want.dtype), want,
                                              err_msg=n)
            elif n == "cost":
                np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=n)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8,
                                           err_msg=n)


def test_escalation_and_polish_sync_free_equals_eager(fx, iris, monkeypatch):
    """(c) element 1's control regularization weight -1e3 makes Quu
    indefinite at low regularization: the fixed stages escalate and leave it
    infeasible, and the while polish's escalation retries its backward pass
    (K3 reports the passes it ran) before a step. The sync-free route, with
    its static bounds, gives the same result bit for bit; both make one
    backward call a direction."""
    ctrl, _ = iris
    buf = _start(fx)
    params = ctrl.update_problem(buf.t, P.expand_params(
        ctrl.params0, 2)._replace(x0=buf.x))
    w = params.node.weight.clone()
    w[1, :, CONTROL_REG] = -1e3
    params = params._replace(node=params.node._replace(weight=w))
    calls, passes = [], []
    bp = riccati_cuda.backward
    monkeypatch.setattr(riccati_cuda, "backward",
                        lambda *a, **k: calls.append(1) or bp(*a, **k))
    esc = riccati_cuda.backward_escalating

    def escalating(*a, **k):
        calls.append(1)
        r = esc(*a, **k)
        passes.append(r[-1])
        return r
    monkeypatch.setattr(riccati_cuda, "backward_escalating", escalating)
    out = {}
    for free in (False, True):
        calls.clear()
        out[free] = ctrl.solve(params, buf.xs, buf.us, settings=SETTINGS,
                               fixed=True, sync_free=free)
        out[free, "calls"] = len(calls)
    eager, sync_free = out[False], out[True]
    for n in eager._fields:
        if n != "trace":
            assert torch.equal(getattr(eager, n), getattr(sync_free, n)), n
    iters = int(eager.iters[1])
    assert iters > ctrl.iters, "the polish did not run"
    assert max(int(p.max()) for p in passes) > 1, \
        "the escalation did not retry"
    # the retries' bound: 18 in float64
    n_retries = fddp.escalation_bound(SETTINGS.solver, SETTINGS.reg_init, F64)
    assert n_retries == 18
    # one call a direction: the stages' and the polish's iterations
    assert out[True, "calls"] == ctrl.iters + ctrl.iters
    assert ctrl.iters < out[False, "calls"] <= out[True, "calls"]


def test_sync_free_tick_reads_nothing_on_the_host(chains):
    """(d) the sync-free chain of the ``chains`` fixture completed with the
    host reads raising and tensors from host data refused (on the card the
    capture's sync debug mode checks the same, and the library calls too:
    chip_smoke.py phase 11)."""
    eager, free = chains
    assert len(free) == TICKS
    assert all(torch.isfinite(r["x"]).all() for r in free)


@pytest.fixture(scope="module")
def smoke():
    """One subprocess: import the serving modules and ``viz``, run
    ``python3 -m eagle_mpc_tpu_torch.realtime --smoke``, then list the
    modules of jax, the JAX package or ``tools`` it imported."""
    code = """
import runpy, sys
import eagle_mpc_tpu_torch.serving_bench, eagle_mpc_tpu_torch.viz
import eagle_mpc_tpu_torch.mpc.graph, eagle_mpc_tpu_torch.utils.rt_executor
sys.argv = ["realtime", "--smoke"]
try:
    runpy.run_module("eagle_mpc_tpu_torch.realtime", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), f"realtime exited {e.code}"
bad = sorted(m for m in sys.modules if m in ("jax", "eagle_mpc_tpu", "tools")
             or m.startswith(("jax.", "eagle_mpc_tpu.", "tools.")))
print("foreign modules:", bad)
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_realtime_smoke(smoke):
    """(e) ``python3 -m eagle_mpc_tpu_torch.realtime --smoke`` prints
    ``SMOKE OK`` after 5 ticks."""
    assert smoke.returncode == 0, smoke.stderr[-3000:]
    assert "SMOKE OK" in smoke.stdout
    assert "ticks=5" in smoke.stderr


def test_serving_modules_import_no_jax(smoke):
    """(g) ``realtime`` (run), ``serving_bench``, ``mpc.graph``,
    ``utils.rt_executor`` and ``viz`` import no jax, JAX package or
    ``tools``."""
    assert smoke.returncode == 0, smoke.stderr[-3000:]
    assert "foreign modules: []" in smoke.stdout


def test_serving_bench_functions(iris, monkeypatch):
    """(f) the bench's workload and run on iris hover (the horizon cut),
    K=2: finite ticks, the graph's callable run eagerly on the CPU."""
    ctrl, _ = iris
    load = sb.load_mpc_params
    monkeypatch.setattr(sb, "load_mpc_params", lambda *a, **k: dataclasses.replace(
        load(*a, **k), knots=ctrl.knots))
    w = sb.workload("iris", "hover", 20, device=CPU, dtype=F64)
    assert float(w.start.t[0]) == 0.0 and w.budget_ms == 20
    r = sb.run(w, K=2, reps=1, eager_reps=1)
    assert not r["captured"]
    for k in ("device_tick_ms", "roundtrip_tick_ms", "eager_tick_ms"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert np.isfinite(r["final_cost"])
