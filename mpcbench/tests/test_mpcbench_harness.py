"""The benchmark harness on the CPU: its files found by name, seeded draws,
work counts, the result line, the import guard, tiny runs of each mix
through the plain versions, and the faults that must read as not correct.

    python -m pytest mpcbench/tests -q -n 0

The tests marked ``cuda`` run on the card (the control at the cells' own
size); they skip where no card is present.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mpcbench import faults  # noqa: E402
from mpcbench.harness import catalog, cell, guard, layers  # noqa: E402
from mpcbench.harness import trace as tr  # noqa: E402
from mpcbench.harness import traffic as trf  # noqa: E402
from mpcbench.reference import compare  # noqa: E402

BENCH = catalog.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "route",
             "checks"}


def tiny(name, batch=None):
    """The cell with its mix cut to a size the CPU runs in seconds. One
    snapshot is compared: its rows go to the reference as the program's
    batch holds them, so on the CPU the plain versions on both sides agree
    to the last bit, and any gap is a fault's."""
    c = catalog.cell(name)
    t = copy.deepcopy(c.traffic)
    t["chain_ticks"] = 2
    t["warm_depth"] = min(t["warm_depth"], 1)
    t["batch"] = batch or min(t["batch"], 2)
    t["sample"].update(ticks=1, rows=min(t["sample"]["rows"], t["batch"]))
    t["trace"].update(ticks=min(t["trace"]["ticks"], 2))
    return c._replace(traffic=t)


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = catalog.cell(name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert c.config["name"] == w["config"]
    assert c.traffic["name"] == w["traffic"]
    held = {k + "_p90" for k in compare.CONTINUOUS + ("cost",)}
    assert "t" in c.limits and set(c.limits) - {"t"} <= held
    assert c.traffic["route"] in ("graph", "eager")
    for m in c.per_layer:
        assert hasattr(catalog.module("metrics", m["name"]), "read")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_is_as_run(entry):
    """The file names its source, lists each changed key in ``reduced``,
    and the controller it builds is the file's (sizes, YAML values)."""
    cfg = catalog.read_json(os.path.join(ROOT, entry["file"]))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    traffic = catalog.data("traffic", "serve-b1")
    from mpcbench.harness import program

    setup = program.controller(cfg, traffic, ROOT, torch.device("cpu"))
    assert setup.ctrl.spec.integrator.lower().startswith(
        "rk4" if "RK4" in cfg["mpc_controller"]["integration_method"]
        else "euler")


def test_unknown_cell_and_file():
    with pytest.raises(KeyError):
        catalog.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        catalog.module("metrics", "no_such_metric.serve")


def test_metric_family_suffix_falls_back():
    a = catalog.module("metrics", "device_idle_pct.serve")
    b = catalog.module("metrics", "device_idle_pct")
    assert a.read.__doc__ == b.read.__doc__


# ---------------------------------------------------------------------------
# seeded draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_draws_repeat(name):
    t = catalog.cell(name).traffic
    x = np.arange(19, dtype=np.float64)
    seed = 2 ** 31 + 12345
    a, b = trf.chain_starts(t, seed, x), trf.chain_starts(t, seed, x)
    assert np.array_equal(a, b)
    other = trf.chain_starts(t, seed + 1, x)
    assert not np.array_equal(a, other)
    if t["draw_seed"] is not None:    # the same scenarios, another order
        assert np.array_equal(np.sort(a, axis=1), np.sort(other, axis=1))
    assert np.all(a[..., 3:7] == x[3:7])
    pa = trf.plan(t, seed, t["chain_ticks"], 64)
    pb = trf.plan(t, seed, t["chain_ticks"], 64)
    assert pa.snaps == pb.snaps and np.array_equal(pa.rows, pb.rows)
    assert pa.first in pa.snaps and pa.complete(pa.snaps)
    taken = sorted(pa.snaps)
    chosen = pa.choose(taken)
    assert chosen == pb.choose(taken) and pa.first in chosen
    assert len(chosen) == t["sample"]["ticks"] == len(set(chosen))
    starts = [p for p in taken if p[1] == 0]
    if t["sample"]["start_tick"]:     # every chain start, up to the sample
        assert len(starts) == 64
        assert sum(p[1] == 0 for p in chosen) == min(64, len(chosen))
    # the window's first chains hold the whole sample
    first = {p for p in pa.snaps if p[0] < trf.MIN_CHAINS}
    assert pa.complete(first)
    # one row from each stratum of the batch
    edges = np.linspace(0, t["batch"], t["sample"]["rows"] + 1).astype(int)
    assert all(edges[i] <= r < edges[i + 1] for i, r in enumerate(pa.rows))


# ---------------------------------------------------------------------------
# work counts
# ---------------------------------------------------------------------------

SMALL = {"B": 1, "T": 2, "nx": 3, "nq": 2, "nv": 1, "ndx": 2, "nu": 1,
         "n_slots": 1, "n_res": 2, "n_state": 1, "n_frame": 0, "nc": 0,
         "rk4": False, "A": 2, "word": 4, "node_dim": 4, "glob_dim": 9}


def test_work_counts_by_hand():
    k = layers.kernels()
    assert set(k) == {"node_linearization", "alpha_rollout",
                      "riccati_backward"}
    # K1, one iteration: T = 2 nodes of nz = 3 directions;
    # 2*2*1*1*3 + 2*216*1 + 0 + 2*36*3 = 12 + 432 + 216 = 660 per node
    # words per node: x 3 + u 1 + params 4 + outputs (1 + 3 + 8 + 4 + 2 + 1
    # + 1) = 28; plus 9 once
    assert k["node_linearization"].work(SMALL, 1) == (2 * 660,
                                                      (2 * 28 + 9) * 4)
    # K2, one iteration: A*T = 4 steps of 2*1*2 + (0 + 4 + 0) = 8 operations
    # reads 9 + 4 + 4 + 6 + 3 + 2 + 8 + 9 = 45 words, writes 2*(6+2+2+3) = 26
    assert k["alpha_rollout"].work(SMALL, 1) == (4 * 8, (45 + 26) * 4 + 2)
    # K3, one iteration: T*(2*2*8 + 2*4 + 2*2 + 2*4) = 2*52 operations;
    # reads 2*(8+4+2+1+1+2) + 2 + 4 + 2 = 44, writes 2*(3+2+2+4) = 22
    assert k["riccati_backward"].work(SMALL, 1) == (104, (44 + 22) * 4 + 1)
    rk4 = dict(SMALL, rk4=True)
    assert k["node_linearization"].work(rk4, 3)[0] == 3 * 2 * 4 * (12 + 2 * 2 * 3 * 4)


def _summary(device_ops, window=(0, 1000)):
    class E:
        def __init__(self, name, a, d, dev, ann=False):
            self._n, self._a, self._d, self._dev, self._ann = name, a, d, dev, ann

        def name(self):
            return self._n

        def start_ns(self):
            return self._a

        def duration_ns(self):
            return self._d

        def device_type(self):
            return self._dev

        def is_user_annotation(self):
            return self._ann
    ev = [E(tr.WINDOW, window[0], window[1] - window[0], "cpu", True),
          E("mpcbench.fetch", 600, 300, "cpu", True),
          E("cudaStreamSynchronize", 650, 200, "cpu")]
    ev += [E(n, a, d, "dev") for n, a, d in device_ops]
    return tr.summarize(ev, "dev")


def test_trace_summary_union_gaps_and_readers():
    s = _summary([("void node_kernel<float>", 100, 200),
                  ("void riccati_kernel<float>", 250, 100),
                  ("Memcpy DtoH", 500, 50),
                  ("aten_add_kernel", 900, 200)])
    assert s.device_ops == 4
    assert s.busy_s == pytest.approx((250 + 50 + 100) * 1e-9)
    assert s.gaps[0] == ("mpcbench.fetch > cudaStreamSynchronize",
                         pytest.approx(350e-9))
    peaks = {"bytes_s": 1.0, "flops": {"float32": 1.0}}
    ctx = layers.Context(s, ticks=2, iterations=1, shape=SMALL, peaks=peaks,
                         dtype="float32")
    assert ctx.kernel_s("node_linearization") == pytest.approx(200e-9)
    assert ctx.plain_s() == pytest.approx(50e-9 + 100e-9)
    read = lambda n: catalog.module("metrics", n).read(ctx)
    assert read("device_idle_pct.serve") == pytest.approx(60.0)
    assert read("device_ops_per_tick.serve") == 2.0
    assert read("plain_ms_per_tick.batch") == pytest.approx(75e-9 * 1e3)
    flops, nbytes = layers.kernels()["node_linearization"].work(SMALL, 1)
    assert read("node_linearization_roofline.serve") == pytest.approx(
        100 * max(flops, nbytes) / 200e-9)
    assert read("alpha_rollout_roofline.batch") is None   # nothing traced
    empty = layers.Context(_summary([]), 2, 1, SMALL, peaks, "float32")
    for m in ("device_idle_pct", "device_ops_per_tick", "plain_ms_per_tick",
              "riccati_backward_roofline"):
        assert catalog.module("metrics", m).read(empty) is None
    assert layers.Context(s, 2, 1, SMALL, None, "float32").roofline_pct(
        "node_linearization") is None
    # where the window's replays were timed, the idle share is theirs
    from mpcbench.harness import window as W
    w = W.Result(seconds=2.0, ticks=50, chains=1, tick_s=[], chain_s=[],
                 records=np.zeros((50, 3, 1)), snapshots=None, replay_s=1.5)
    timed = layers.Context(s, 2, 1, SMALL, peaks, "float32", w)
    assert catalog.module("metrics", "device_idle_pct.serve").read(
        timed) == pytest.approx(25.0)
    untimed = layers.Context(s, 2, 1, SMALL, peaks, "float32",
                             w._replace(replay_s=None))
    assert catalog.module("metrics", "device_idle_pct.batch").read(
        untimed) == pytest.approx(60.0)


# ---------------------------------------------------------------------------
# the import guard
# ---------------------------------------------------------------------------

def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["jax.numpy", "numpy"]) == ["jax"]
    assert guard.forbidden(["eagle_mpc_tpu.ops"]) == ["eagle_mpc_tpu"]
    assert guard.forbidden(["eagle_mpc_tpu_torch.ops", "toolsx",
                            "jaxtyping", "mpcbench.tools"]) == []
    assert guard.forbidden(["tools.make_ref", "flax", "jaxlib"]) == [
        "flax", "jaxlib", "tools"]


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import mpcbench.reference.tick, mpcbench.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"eagle_mpc_tpu_torch", "eagle_mpc_tpu", "jax",
                       "jaxlib", "flax", "tools"}


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "mpcbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


# ---------------------------------------------------------------------------
# tiny runs of each mix through the plain versions, and the faults
# ---------------------------------------------------------------------------

def _run(c, traced=False, fault=None, seed=7):
    return cell.run(c, seed, 0.01, traced, torch.device("cpu"),
                    time.perf_counter(), fault=fault, log=lambda *a: None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
def test_tiny_run_reaches_its_line(name, traced):
    c = tiny(name)
    line = _run(c, traced)
    keys = LINE_KEYS | ({"breakdown"} if traced else set())
    assert set(line) == keys and list(line)[-1] == "checks"
    json.dumps(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= c.traffic["batch"] and line["failed"] == 0
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    if traced:
        assert set(line["metrics"]) <= want     # no device events on the CPU
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == want
    assert set(line["checks"]) == set(c.limits)
    assert line["route"] == c.traffic["route"]


def _applies(name, fault):
    """Whether the cell can have the fault: a part of the batch needs more
    than one scenario, a cold start a sample that compares chain starts."""
    t = catalog.cell(name).traffic
    if fault in ("half", "third"):
        return t["batch"] > 1
    if fault == "cold":
        return t["sample"]["start_tick"]
    return True


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_reads_not_correct(name, fault):
    if not _applies(name, fault):
        pytest.skip(f"{name} cannot have the fault {fault}")
    c = tiny(name, batch=12 if fault in ("half", "third") else None)
    line = _run(c, fault=faults.FAULTS[fault])
    assert line["correct"] is False, line["checks"]


def test_graph_route_does_not_fall_back(monkeypatch):
    """A capture that fails on a graph cell ends the run."""
    from eagle_mpc_tpu_torch.mpc import graph as G

    def refuse(*a, **k):
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(G, "CapturedStep", refuse)
    name = next(n for n in CELLS
                if catalog.cell(n).traffic["route"] == "graph")
    with pytest.raises(RuntimeError):
        _run(tiny(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_fault_read_not_correct_on_the_card(name):
    """The control (the reference in TF32 in the program's place) and the
    fault on a minority of the rows that the cell can have (a third of the
    batch, or the cold starts alone) fail the cell's limits on three seeds
    each at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from mpcbench import calibrate

    c = catalog.cell(name)
    fault = "third" if _applies(name, "third") else "cold"
    r = calibrate.readings(c, [], [9001, 9002, 9003], BENCH["run_seconds"],
                           torch.device("cuda", 0), lambda rec: None, fault,
                           [9004, 9005, 9006])
    assert len(r["control"]) == 3 and len(r["fault"]) == 3
    for g in r["control"] + r["fault"]:
        ok, checks = compare.judge(g, c.limits)
        assert not ok, checks
