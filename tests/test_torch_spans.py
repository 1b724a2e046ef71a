"""The port's spans and counters (``eagle_mpc_tpu_torch.utils.spans``) on
the CPU, float64: off by default, where the program dispatches the same
operations as before they existed and allocates no counter; on, where the
served tick and the eager fixed solve give the same outputs bit for bit,
the spans have the documented names, parents and tick ids, and the
sync-free route counts the backward passes that the eager route runs; a
CUDA graph's replays read through a stand-in graph; and
``profile_tick.py``'s span table. Iris hover at 5 knots, as in
tests/test_torch_serving.py."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eagle_mpc_tpu_torch import profile_tick
from eagle_mpc_tpu_torch.config import load_ref
from eagle_mpc_tpu_torch.mpc import CarrotMpc
from eagle_mpc_tpu_torch.mpc import graph as G
from eagle_mpc_tpu_torch.mpc.carrot import CONTROL_REG
from eagle_mpc_tpu_torch.ocp import problem as P
from eagle_mpc_tpu_torch.ops import riccati_cuda
from eagle_mpc_tpu_torch.sim import AerialSimulator
from eagle_mpc_tpu_torch.solvers import fddp, sbfddp
from eagle_mpc_tpu_torch.utils import spans

from torch_port_util import CPU, F64, load_port

KNOTS = 5
SETTINGS = sbfddp.SbFddpSettings(convergence_init=1e-3,
                                 solver=fddp.SolverSettings())
# aten operations one eager tick of ``_tick(..., sync_free=False)``
# dispatches after one tick has made the lazily cached constants, with
# tracing off (PyTorch 2.13); the plain escalation of K3's direction
# (``riccati_cuda.backward_escalating_plain``) counts its rows' passes
EAGER_TICK_OPS = 97950
# backward passes the eager route ran for ``_forced(iris, 1)``'s element
# while the escalation's rounds ran on the host, one call a pass (counted
# on the tree before K3 escalated in the kernel): 4 directions, 12 retries
FORCED_EAGER_PASSES = 16


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh tracing state for each test, off."""
    r = spans._Recorder()
    monkeypatch.setattr(spans, "_R", r)
    return r


@pytest.fixture(scope="module")
def iris():
    traj, mp = load_port("iris", "hover")
    mp = dataclasses.replace(mp, knots=KNOTS)
    ref, _ = load_ref("iris", "hover", 20, traj=traj)
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref,
                     dt_ref=20, device=CPU, dtype=F64)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, 2.0,
                                        device=CPU, dtype=F64)
    return ctrl, sim


def _buffers(ctrl, B=2):
    """Two scenarios at hover, the second 0.1 m off."""
    x0 = torch.zeros(B, ctrl.spec.model.nx, dtype=F64)
    x0[:, 2], x0[:, 6] = 1.0, 1.0
    x0[1:, 0] = 0.1
    T = ctrl.spec.T
    xs = x0[:, None].expand(B, T + 1, x0.shape[1])
    us = torch.full((B, T, ctrl.spec.nu), 2.5, dtype=F64)
    return G.make_buffers(0.0, x0, xs, us)


def _tick(iris, sync_free, n=1):
    """``n`` served ticks through a ``CapturedStep`` (eager on the CPU):
    the outputs and the buffers after each."""
    ctrl, sim = iris
    buf = _buffers(ctrl)
    step = G.CapturedStep(G.serving_tick(ctrl, sim, SETTINGS, 2.0, buf,
                                         sync_free=sync_free), CPU, state=buf)
    out = []
    for _ in range(n):
        o = step.replay()
        out.append(tuple(o) + tuple(a.clone() for a in buf))
    return out


def _forced(iris, B):
    """Update-problem params whose element B-1 has a control
    regularization weight of -1e3: Quu is indefinite at low
    regularization, so its passes escalate and the polish runs."""
    ctrl, _ = iris
    buf = _buffers(ctrl, B)
    params = ctrl.update_problem(buf.t, P.expand_params(
        ctrl.params0, B)._replace(x0=buf.x))
    w = params.node.weight.clone()
    w[-1, :, CONTROL_REG] = -1e3
    return buf, params._replace(node=params.node._replace(weight=w))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_off_dispatches_the_same_operations_and_keeps_nothing(iris,
                                                              recorder):
    ctrl, sim = iris
    _tick(iris, sync_free=False)        # the cached constants, whatever ran
    buf = _buffers(ctrl)
    step = G.CapturedStep(G.serving_tick(ctrl, sim, SETTINGS, 2.0, buf,
                                         sync_free=False), CPU, state=buf)
    assert not spans.on()
    with _Count() as c:
        step.replay()
    assert c.n == EAGER_TICK_OPS
    rec = spans.take()
    assert rec.spans == [] and rec.ticks == 0
    assert set(rec.counters.values()) == {0}
    assert recorder.rows == {}, "a counter tensor while tracing is off"


TREE = {"mpc.update": {None}, "sim.step": {None}, "solver.iteration": {None},
        "ocp.terminal": {"solver.iteration"},
        "solver.escalation": {"solver.iteration"},
        "solver.gaps": {"solver.iteration"},
        "solver.backward": {"solver.iteration", "solver.escalation"},
        "k1": {"solver.iteration"}, "k3": {"solver.backward"},
        "solver.line_search": {"solver.iteration"},
        "k2": {"solver.line_search"},
        "solver.expected_improvement": {"solver.line_search"}}


def test_on_gives_the_same_outputs_and_the_documented_spans(iris):
    """The f64 served tick (sync-free, 2 ticks) and the eager fixed solve
    of a problem that escalates, with tracing off and on (every span):
    the same outputs bit for bit; the ticks' spans have the documented
    names, parents (each inside its parent on the host clock) and tick
    ids, and the counters count 2 rows a launch."""
    buf, params = _forced(iris, 2)
    ctrl, _ = iris
    off = (_tick(iris, sync_free=True, n=2),
           ctrl.solve(params, buf.xs, buf.us, settings=SETTINGS, fixed=True))
    spans.enable(detail=True)
    ticks = _tick(iris, sync_free=True, n=2)
    rec = spans.take()
    solve = ctrl.solve(params, buf.xs, buf.us, settings=SETTINGS, fixed=True)
    assert spans.take().spans
    spans.disable()
    for a, b in zip(off[0], ticks):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for n in solve._fields:
        if getattr(solve, n) is not None:
            assert torch.equal(getattr(off[1], n), getattr(solve, n)), n
    assert int(solve.iters[1]) > ctrl.iters, "the polish did not run"

    assert rec.ticks == 2
    assert {s.name for s in rec.spans} == set(TREE) == set(spans.NAMES) - {
        "graph.launch"}
    by_tick = {}
    for s in rec.spans:
        by_tick.setdefault(s.tick, []).append(s)
        assert s.device_ms is None              # no CUDA here
        assert s.host_start_ns <= s.host_end_ns
        assert s.parent in TREE[s.name], (s.name, s.parent)
    a, b = sorted(by_tick)
    assert b == a + 1
    for group in by_tick.values():
        names = [s.name for s in group]
        assert names.count("mpc.update") == names.count("sim.step") == 1
        # the fixed stage's 2 iterations and the sync-free polish's 2
        assert names.count("solver.iteration") == 4
        assert names.count("ocp.terminal") == 4
        assert names.count("solver.escalation") == 2
        # one K3 launch a direction, the escalation inside it
        assert names.count("k3") == 4
        for s in group:
            if s.parent is not None:
                assert any(p.name == s.parent
                           and p.host_start_ns <= s.host_start_ns
                           and s.host_end_ns <= p.host_end_ns for p in group)
    c = rec.counters
    k3 = sum(s.name == "k3" for s in rec.spans)
    assert c["backward.row_passes"] == 2 * k3
    assert c["solver.row_iterations"] == 2 * 2 * 4
    assert 0 < c["solver.row_iterations_active"] <= 16
    assert 0 < c["backward.row_passes_needed"] < c["backward.row_passes"]
    assert profile_tick.useful_shares(rec) == [
        (needed, c[needed], c[launched], 100 * c[needed] / c[launched])
        for launched, needed in spans.COUNTERS]
    table = profile_tick.span_table(rec, 2)
    assert {r[0] for r in table} == set(TREE)
    assert dict((r[0], r[3]) for r in table)["k3"] == k3 / 2


def test_sync_free_counts_the_passes_the_eager_route_runs(iris, monkeypatch):
    """One element whose passes escalate: both routes make one backward
    call a direction (K3 runs the escalation's retries inside the launch)
    and count the same passes as needed, the passes the eager route ran
    when the host ran the rounds (pinned), and the retries among them.
    Tracing is on without its detail spans."""
    ctrl, _ = iris
    buf, params = _forced(iris, 1)
    calls = []
    for name in ("backward", "backward_escalating"):
        monkeypatch.setattr(riccati_cuda, name,
                            lambda *a, _f=getattr(riccati_cuda, name), **k:
                            calls.append(1) or _f(*a, **k))
    spans.enable()
    counted = {}
    for free in (False, True):
        calls.clear()
        ctrl.solve(params, buf.xs, buf.us, settings=SETTINGS, fixed=True,
                   sync_free=free)
        rec = spans.take()
        directions = sum(s.name == "solver.iteration" for s in rec.spans)
        counted[free] = (len(calls), directions, rec.counters)
        # without detail, the metric spans alone
        assert {s.name for s in rec.spans} == {
            "solver.iteration", "ocp.terminal", "solver.escalation"}
    eager_calls, eager_dirs, eager = counted[False]
    free_calls, free_dirs, free = counted[True]
    assert eager_calls == eager_dirs == free_calls == free_dirs == 4
    for c in (eager, free):
        assert c["backward.row_passes"] == eager_calls
        assert c["backward.row_passes_needed"] == FORCED_EAGER_PASSES
        assert (c["backward.row_retries"] == FORCED_EAGER_PASSES - eager_calls
                > 0), "the escalation did not retry"
    assert (free["solver.row_iterations_active"]
            == eager["solver.row_iterations_active"]
            == eager["solver.row_iterations"])


class _Event:
    """Stands in for a timing event: ``ms`` its time on a device clock."""

    def __init__(self, ms):
        self.ms = ms
        self.waited = False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, other):
        return other.ms - self.ms


class _Graph:
    def __init__(self, cap):
        self.cap, self.replays = cap, 0

    def replay(self):
        """Re-records the captured events, each replay 1 ms later."""
        self.replays += 1
        for i, (_, _, a, b) in enumerate(self.cap.spans):
            a.ms, b.ms = self.replays + 0.1 * i, self.replays + 0.1 * i + 0.05


def test_replays_read_each_graph_replay(recorder):
    """A captured step's replays: each begins a tick, its spans are read
    before the next replay and carry its tick, and the rows counted at the
    capture are added at every replay, with tracing off too; the launch is
    a host span for a graph captured with tracing off alone."""
    spans.enable()
    cap = spans.Captured()
    cap.new_tick = True
    cap.spans = [("ocp.terminal", "solver.iteration", _Event(0), _Event(0)),
                 ("solver.iteration", None, _Event(0), _Event(0))]
    cap.launched = {"backward.row_passes": 42}
    g = _Graph(cap)
    spans.replay(g, cap)
    assert cap.pending == 1 and not cap.spans[-1][3].waited
    spans.replay(g, cap)
    assert cap.spans[-1][3].waited
    rec = spans.take()
    assert rec.ticks == 2 and cap.pending is None
    assert "graph.launch" not in {s.name for s in rec.spans}
    timed = [(s.name, s.parent, s.tick) for s in rec.spans
             if s.device_ms is not None]
    assert timed == [("ocp.terminal", "solver.iteration", 1),
                     ("solver.iteration", None, 1),
                     ("ocp.terminal", "solver.iteration", 2),
                     ("solver.iteration", None, 2)]
    assert all(s.device_ms == pytest.approx(0.05) for s in rec.spans
               if s.device_ms is not None)
    assert rec.counters["backward.row_passes"] == 84
    # a step captured with tracing off begins no tick; its launch is timed
    later = spans.Captured()
    spans.replay(_Graph(later), later)
    spans.replay(g, cap)
    spans.replay(_Graph(later), later)
    rec = spans.take()
    assert rec.ticks == 1
    launch = [s for s in rec.spans if s.name == "graph.launch"]
    assert [s.tick for s in launch] == [2, 3]
    assert all(s.device_ms is None and s.host_end_ns >= s.host_start_ns
               for s in launch)
    # off: a captured step's replays of the instrumented graph still count
    # its launched rows (its nodes add the rows that did work), read no
    # spans; enable() starts from an empty record
    spans.disable()
    step = G.CapturedStep(lambda: None, CPU)
    step.graph, step.traced = g, cap
    step.replay()
    assert g.replays == 4 and cap.pending is None
    assert spans.take().counters["backward.row_passes"] == 42
    step.replay()
    spans.enable()
    assert spans.take().counters["backward.row_passes"] == 0
    spans.disable()
    with spans.capture() as off:
        spans.count(spans.PASSES, torch.ones(3, dtype=torch.bool))
    assert off.spans == [] and off.launched == {} and recorder.rows == {}
    assert not off.instrumented and cap.instrumented


def test_counters_sum_masks_per_row():
    spans.enable()
    a = torch.tensor([True, False, True])
    b = torch.tensor([True, True, False])
    spans.count(spans.PASSES, a)
    spans.count(spans.PASSES, a, b)
    c = spans.take().counters
    assert c["backward.row_passes"] == 6
    assert c["backward.row_passes_needed"] == 3
    assert np.all(np.array(list(spans.take().counters.values())) == 0)


def test_counters_sum_passes_and_retries_per_row():
    """A launch that counts each row's passes, and the single counter of
    the retries: summed per row on the device, B rows launched on the
    host, nothing kept while tracing is off."""
    active = torch.tensor([True, False, True])
    passes = torch.tensor([1, 4, 3], dtype=torch.int32)
    spans.add(spans.RETRIES, active, values=passes - 1)
    spans.count(spans.PASSES, active, values=passes)
    assert spans.take().counters[spans.RETRIES] == 0
    spans.enable()
    spans.count(spans.PASSES, active, values=passes)
    spans.add(spans.RETRIES, active, values=passes - 1)
    spans.add(spans.RETRIES, torch.tensor([False, True, True]), active)
    c = spans.take().counters
    assert c["backward.row_passes"] == 3
    assert c["backward.row_passes_needed"] == 4
    assert c[spans.RETRIES] == 2 + 1
