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
then the same 10 under the profiler. The solver's named functions are wrapped in
``torch.profiler.record_function`` for the profiled window only. Prints
the card's name and power limit, the span table (ms per call under the
profiler, calls per tick or per solver iteration), the three kernels'
device time per launch, and the device busy share: the profiler's self
device time over the profiled wall time. The wrapping lives in this
process alone; the main path has no option for it. Run from the root of
a checkout.
"""

import functools
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = 3


def _spans(ctrl_cls):
    """(owner, attribute, span name) of each function the profile wraps."""
    from .ocp import problem as P
    from .ops import node_cuda, riccati_cuda, rollout_cuda
    from .sim import AerialSimulator
    from .solvers import fddp

    return [
        (ctrl_cls, "update_problem", "update_problem"),
        (fddp, "_fixed_iteration", "fixed_iteration"),
        (fddp, "solve_while_fixed_body", "polish_while_fixed"),
        (P, "terminal_calc_diff", "terminal_calc_diff"),
        (fddp, "_gaps", "gaps"),
        (fddp, "_backward_pass", "backward_pass"),
        (fddp, "_forward_pass_multi", "forward_pass_multi"),
        (fddp, "_expected_improvement", "expected_improvement"),
        (node_cuda, "calc_diff_running", "K1 wrapper"),
        (riccati_cuda, "backward", "K3 wrapper"),
        (rollout_cuda, "rollout", "K2 wrapper"),
        (AerialSimulator, "step", "sim_step"),
    ]


def _offline_spans():
    """(owner, attribute, span name) of each function the offline profile
    wraps."""
    from .ocp import problem as P
    from .ops import node_cuda, riccati_cuda, rollout_cuda
    from .solvers import fddp

    return [
        (fddp, "_while_iteration", "while_iteration"),
        (fddp, "_compute_direction", "compute_direction"),
        (P, "terminal_calc_diff", "terminal_calc_diff"),
        (fddp, "_gaps", "gaps"),
        (fddp, "_backward_pass", "backward_pass"),
        (fddp, "_line_search", "line_search"),
        (fddp, "_forward_pass_multi", "forward_pass_multi"),
        (fddp, "_expected_improvement", "expected_improvement"),
        (P, "total_cost", "total_cost"),
        (node_cuda, "calc_diff_running", "K1 wrapper"),
        (riccati_cuda, "backward", "K3 wrapper"),
        (rollout_cuda, "rollout", "K2 wrapper"),
    ]


def _closed_loop_spans(ctrl_cls):
    """(owner, attribute, span name) of each function the closed-loop
    profile wraps: the offline ones, the update and the plant."""
    from .sim import AerialSimulator

    return [(ctrl_cls, "update_problem", "update_problem")] + _offline_spans() + [
        (AerialSimulator, "step", "sim_step")]


def _wrap(fn, name):
    import torch

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


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
    _profile_and_report(device, _spans(type(ctrl)), run, TICKS, "tick")


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
    _profile_and_report(device, _offline_spans(), solve, iters, "iteration")


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
    _profile_and_report(device, _closed_loop_spans(type(ctrl)),
                        lambda: run(TICKS), TICKS, "tick")


def profile_serving(device, ticks=10):
    """The served tick (module docstring): its CUDA graph's replays, then
    the eager tick on the solve's default route; prints both reports per
    tick."""
    import torch

    from . import serving_bench as sb
    from .mpc import graph as G
    from .solvers import fddp

    w = sb.workload(device=device)
    buf = w.start.clone()
    step = G.CapturedStep(G.serving_tick(w.ctrl, w.sim, w.settings,
                                         sb.DT_PLANT, buf), device, state=buf)
    eager = G.serving_tick(w.ctrl, w.sim, w.settings, sb.DT_PLANT, buf,
                           sync_free=False)
    spans = _closed_loop_spans(type(w.ctrl)) + [
        (fddp, "_fixed_iteration", "fixed_iteration")]
    for label, fn, sp in (("graph replay", step.replay, []),
                          ("eager tick (default route)", eager, spans)):
        run = lambda: [fn() for _ in range(ticks)]
        sb.reset(buf, w.start)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) / ticks * 1e3
        print(f"serving {label} f32 B=1: {tick_ms:.3f} ms per tick "
              f"unprofiled ({ticks} ticks)", flush=True)
        sb.reset(buf, w.start)
        fn()
        torch.cuda.synchronize()
        _profile_and_report(device, sp, run, ticks, "tick")


def _profile_and_report(device, spans, run, n, unit):
    """``run()`` under the profiler with ``spans`` wrapped; prints the span
    table per ``unit`` (``n`` of them in the run), each kernel's device
    time per launch and the device busy share."""
    import torch
    from torch.autograd import DeviceType

    originals = [getattr(owner, attr) for owner, attr, _ in spans]
    for (owner, attr, name), fn in zip(spans, originals):
        setattr(owner, attr, _wrap(fn, name))
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (owner, attr, _), fn in zip(spans, originals):
            setattr(owner, attr, fn)

    events = prof.key_averages()
    by_key = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    print(f"{wall_ms / n:.3f} ms per {unit} under the profiler ({n} of them)",
          flush=True)
    print(f"| Span (profiled) | ms per call | calls per {unit} |")
    print("|---|---|---|")
    rows = sorted((by_key[name] for _, _, name in spans if name in by_key),
                  key=lambda e: -e.cpu_time_total)
    for e in rows:
        print(f"| `{e.key}` | {e.cpu_time_total / e.count / 1e3:.3f} | "
              f"{e.count / n:.2f} |")
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
