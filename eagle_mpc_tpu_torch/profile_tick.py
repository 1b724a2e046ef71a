"""Profile the port's flagship tick or offline solve on one card: where
the time goes.

    python3 -m eagle_mpc_tpu_torch.profile_tick [carrot|weighted|rail|rk4|offline|closed_loop|contacts|serving]

Runs a path of ``chip_smoke.py`` (hexacopter370_flying_arm_3 displacement,
float32; the carrot path by default; ``rk4`` the carrot with RK4 nodes,
``chip_smoke.py``'s phase 9). An MPC path (offline reference,
B=512, from its start time): the depth-30 warm start and one settle chunk
of 10 chained ticks, then 3 ticks unprofiled (the tick time) and 3 more
under ``torch.profiler``. ``offline``: the offline solve at B=1 (T=132,
``sbfddp.solve``, maxiter 400), once to warm up, once unprofiled and once
under the profiler. ``contacts``: the same for the contact mission
eagle_catch at dt 50 ms (T=70, a 3-D contact and a friction cone;
``chip_smoke.py``'s phase 8, maxiter 150). ``closed_loop``: the B=1 closed loop of
``chip_smoke.py``'s phase 7 (``run_closed_loop``, the while-loop route),
10 ticks to warm up, 10 unprofiled (the tick time) and 3 from the start
under the profiler, per tick. ``serving``: the served tick of
``serving_bench`` (the flagship, B=1, float32, t0=3500 ms), 10 replays of
its CUDA graph and then 10 eager ticks on the solve's default route, each
from the bench's start after one untimed tick: the tick time unprofiled,
then the same 10 under the profiler (the replays from a second capture of
the tick, made with the spans on), and the host's launch of the first
capture's replays (``graph.launch``: a graph captured with the spans off,
since event nodes make the launch take the graph's device time). The span
table and the counters come from the program's own spans
(``utils.spans``, with its detail spans), switched on for the profiled
window only; tracing is off everywhere else, so the unprofiled times are
the untraced program's. Prints the card's name and power limit, the span
table (host and device ms per call, calls per tick or per solver
iteration; spans replayed by a CUDA graph have device times only), each
counter pair's rows that did work over the rows launched (backward
passes, retries included, over K3's rows launched; solver iterations),
the escalation's retries (``backward.row_retries``), the three kernels'
device time per launch,
and the device busy share: the profiler's self device time over the
profiled wall time. Run from the root of a checkout.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = 3


def device_us(evt):
    """Self device time of a device event (a kernel, a copy); 0 for host
    events and for the device's copies of the annotations."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
        return 0.0
    return evt.self_device_time_total


def profile(device, batch, path="carrot"):
    """Warm start, settle, time and profile a path on ``device`` (float32,
    ``batch`` scenarios) with ``chip_smoke``'s warm start and tick; prints
    the report."""
    import torch

    import chip_smoke as cs

    dtype = torch.float32
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    controller, t0, _, _, _ = cs.PATHS[path]
    ctrl, sim, ref, hover, n_rot = cs.flagship(device, dtype, controller)
    B = batch
    t_ms = t0 - cs.TICKS * cs.DT_SIM
    xb, xs, us = cs.initial_batch(ctrl, ref, hover, n_rot, B, t_ms, device, dtype)

    def tick(state):
        t_ms, xb, xs, us = state
        r, xb = cs.tick(ctrl, sim, t_ms, xb, xs, us)
        return t_ms + cs.DT_SIM, xb, r.xs, r.us

    w = cs.warm_start(ctrl, t_ms, xb, xs, us)
    state = (t_ms, xb, w.xs, w.us)
    for _ in range(cs.TICKS):
        state = tick(state)
    sync()
    t0 = time.perf_counter()
    for _ in range(TICKS):
        state = tick(state)
    sync()
    tick_ms = (time.perf_counter() - t0) / TICKS * 1e3

    def run():
        nonlocal state
        for _ in range(TICKS):
            state = tick(state)

    print(f"{path} tick f32 B={B}: {tick_ms:.3f} ms unprofiled", flush=True)
    _profile_and_report(device, run, TICKS, "tick")


def profile_offline(device, contacts=False):
    """The offline solve of ``chip_smoke``'s phase offline (float32, B=1),
    or with ``contacts`` that of eagle_catch in its phase contacts:
    warm-up, timed and profiled; prints the report per solver
    iteration."""
    import torch

    import chip_smoke as cs
    from .solvers import sbfddp

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if contacts:
        spec, params = cs.contact_problem(device, torch.float32,
                                          *cs.CONTACT_MISSIONS["ec"])
        maxiter = cs.CONTACT_MAXITER
    else:
        spec, params = cs.offline_problem(device, torch.float32)
        maxiter = cs.OFFLINE_MAXITER
    solve = lambda: sbfddp.solve(spec, params, maxiter=maxiter)
    solve()
    sync()
    t0 = time.perf_counter()
    res = solve()
    sync()
    solve_ms = (time.perf_counter() - t0) * 1e3
    iters = int(res.iters[0])
    print(f"{'contacts' if contacts else 'offline'} solve f32 B=1 T={spec.T}: "
          f"{solve_ms:.3f} ms unprofiled, "
          f"{iters} iterations, {solve_ms / iters:.3f} ms per iteration",
          flush=True)
    _profile_and_report(device, solve, iters, "iteration")


def profile_closed_loop(device, ticks=10):
    """The closed loop of ``chip_smoke``'s phase 7, step 2 (float32, B=1,
    the while-loop route): warm-up, timed and profiled; prints the report
    per tick."""
    import torch

    import chip_smoke as cs
    from .mpc import run_closed_loop

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ctrl, sim, _, _, _, x0, xs_w, us_w = cs.closed_loop_setup(device,
                                                               torch.float32)
    run = lambda n: run_closed_loop(ctrl, sim, x0, xs_w, us_w, n_steps=n,
                                    dt_sim_ms=cs.DT_SIM)
    run(ticks)
    sync()
    t0 = time.perf_counter()
    run(ticks)
    sync()
    tick_ms = (time.perf_counter() - t0) / ticks * 1e3
    print(f"closed loop f32 B=1 (while route): {tick_ms:.3f} ms per tick "
          f"unprofiled ({ticks} ticks)", flush=True)
    _profile_and_report(device, lambda: run(TICKS), TICKS, "tick")


def profile_serving(device, ticks=10):
    """The served tick (module docstring): its CUDA graph's replays, then
    the eager tick on the solve's default route; prints both reports per
    tick."""
    import torch

    from . import serving_bench as sb
    from .mpc import graph as G
    from .utils import spans

    w = sb.workload(device=device)
    buf = w.start.clone()
    tick = G.serving_tick(w.ctrl, w.sim, w.settings, sb.DT_PLANT, buf)
    step = G.CapturedStep(tick, device, state=buf)
    spans.enable(detail=True)
    traced = G.CapturedStep(tick, device, state=buf)
    spans.disable()
    eager = G.serving_tick(w.ctrl, w.sim, w.settings, sb.DT_PLANT, buf,
                           sync_free=False)
    for label, fn, profiled in (
            ("graph replay", step.replay, traced.replay),
            ("eager tick (default route)", eager, eager)):
        run = lambda f=fn: [f() for _ in range(ticks)]
        sb.reset(buf, w.start)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) / ticks * 1e3
        print(f"serving {label} f32 B=1: {tick_ms:.3f} ms per tick "
              f"unprofiled ({ticks} ticks)", flush=True)
        if fn == step.replay:
            launch_ms = _launch_ms(run)
            print(f"graph.launch: {launch_ms:.3f} ms host time per replay "
                  f"(a graph captured with the spans off)", flush=True)
        sb.reset(buf, w.start)
        profiled()
        torch.cuda.synchronize()
        _profile_and_report(
            device, lambda f=profiled: [f() for _ in range(ticks)], ticks,
            "tick")


def _launch_ms(run):
    """Mean host ms of ``graph.launch`` per replay over ``run()``, replays
    of a graph captured with the spans off, with the spans on (which then
    record that span alone)."""
    from .utils import spans

    spans.enable()
    try:
        run()
        launch = [s for s in spans.take().spans if s.name == "graph.launch"]
    finally:
        spans.disable()
    return (sum(s.host_end_ns - s.host_start_ns for s in launch) * 1e-6
            / len(launch))


def useful_shares(record):
    """Rows of ``record``'s counters (``utils.spans.take()``): (rows that
    did work, rows launched, their share in %) of each counter pair that
    launched any."""
    from .utils import spans

    c = record.counters
    return [(needed, c[needed], c[launched], 100 * c[needed] / c[launched])
            for launched, needed in spans.COUNTERS if c[launched]]


def span_table(record, n):
    """Rows of the span table of ``record`` (``utils.spans.take()``) over
    ``n`` units: (name, host ms per call or None, device ms per call or
    None, calls per unit), the largest total time first."""
    by_name = {}
    for s in record.spans:
        by_name.setdefault(s.name, []).append(s)
    rows = []
    for name, group in by_name.items():
        host = [(s.host_end_ns - s.host_start_ns) * 1e-6 for s in group
                if s.host_start_ns is not None]
        dev = [s.device_ms for s in group if s.device_ms is not None]
        mean = lambda v: sum(v) / len(v) if v else None
        rows.append((name, mean(host), mean(dev), len(group) / n,
                     max(sum(host), sum(dev))))
    rows.sort(key=lambda r: -r[4])
    return [r[:4] for r in rows]


def _profile_and_report(device, run, n, unit):
    """``run()`` under the profiler with the program's spans on (its
    detail spans too); prints the span table per ``unit`` (``n`` of them
    in the run), each kernel's device time per launch and the device busy
    share."""
    import torch

    from .utils import spans

    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    spans.enable(detail=True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        record = spans.take()
    finally:
        spans.disable()

    events = prof.key_averages()
    print(f"{wall_ms / n:.3f} ms per {unit} under the profiler ({n} of them)",
          flush=True)
    print(f"| Span (profiled) | host ms per call | device ms per call | "
          f"calls per {unit} |")
    print("|---|---|---|---|")
    fmt = lambda v: "-" if v is None else f"{v:.3f}"
    for name, host, dev, calls in span_table(record, n):
        print(f"| `{name}` | {fmt(host)} | {fmt(dev)} | {calls:.2f} |")
    for name, needed, launched, pct in useful_shares(record):
        print(f"{name}: {needed} over {launched} rows launched, {pct:.2f} %")
    retries = record.counters[spans.RETRIES]
    print(f"{spans.RETRIES}: {retries} retries of the escalation, "
          f"{retries / n:.2f} per {unit}")
    for kernel in ("node_kernel", "node_rk4_kernel", "riccati_kernel",
                   "rollout_kernel"):
        ks = [e for e in events if kernel in e.key and device_us(e) > 0]
        k = sum(e.count for e in ks)
        if k:
            print(f"{kernel}: {sum(device_us(e) for e in ks) / k / 1e3:.4f} ms "
                  f"device time per launch, {k / n:.2f} launches per {unit}")
    busy_ms = sum(device_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events if device_us(e) > 0)
    print(f"device busy: {busy_ms:.1f} ms of self device time in {wall_ms:.1f} ms "
          f"of wall, {100 * busy_ms / wall_ms:.1f} %; {launches / n:.0f} "
          f"device operations per {unit}", flush=True)


def main(args):
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; the profile needs an "
              "NVIDIA GPU", flush=True)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    for path in args or ["carrot"]:
        if path in ("offline", "contacts"):
            profile_offline(torch.device("cuda", 0), path == "contacts")
        elif path == "closed_loop":
            profile_closed_loop(torch.device("cuda", 0))
        elif path == "serving":
            profile_serving(torch.device("cuda", 0))
        else:
            profile(torch.device("cuda", 0), cs.BATCH, path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
