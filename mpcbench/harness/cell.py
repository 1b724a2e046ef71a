"""One run of one cell: set-up, the window or the traced stretch, the check
against the reference, and the result line's fields."""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..reference import compare, health
from ..reference.tick import ReferenceTick
from . import catalog, layers, program
from . import trace as tr
from . import traffic as trf
from . import window as W


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi, None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(device: torch.device, peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak,
            "power_limit_w": power_limit_w()}


def _starts(setup: program.Setup, traffic: Dict, seed: int) -> W.Starts:
    x0 = trf.chain_starts(traffic, seed, setup.x_t0)
    dt, dev = setup.dtype, setup.device
    x_dev = torch.as_tensor(x0, dtype=dt, device=dev)
    warm_xs = warm_us = None
    if traffic["start"] == "warm":
        B, T = x_dev.shape[1], setup.ctrl.spec.T
        xs = x_dev[0][:, None].expand(B, T + 1, x_dev.shape[2]).contiguous()
        us = setup.hover_us.expand(B, *setup.hover_us.shape).contiguous()
        w = program.warm_start(setup.ctrl, float(traffic["t0_ms"]), x_dev[0],
                               xs, us, traffic["warm_depth"])
        warm_xs, warm_us = w.xs.contiguous(), w.us.contiguous()
    elif traffic["start"] != "cold":
        raise ValueError(f"start must be cold or warm, got {traffic['start']!r}")
    return W.Starts(x_dev=x_dev, x_host=torch.as_tensor(x0, dtype=dt),
                    warm_xs=warm_xs, warm_us=warm_us,
                    hover_us=setup.hover_us, t0_ms=float(traffic["t0_ms"]))


def _first_buffers(starts: W.Starts):
    """The buffers' contents at chain 0's start, for the capture."""
    from eagle_mpc_tpu_torch.mpc import graph as G

    x = starts.x_dev[0]
    B, T = x.shape[0], starts.hover_us.shape[0]
    if starts.warm_xs is not None:
        xs, us = starts.warm_xs, starts.warm_us
    else:
        xs = x[:, None].expand(B, T + 1, x.shape[1])
        us = starts.hover_us.expand(B, *starts.hover_us.shape)
    return G.make_buffers(starts.t0_ms, x, xs, us)


def stack(snaps: Dict, chosen, rows):
    """(inputs, outputs) of the chosen snapshots' sampled rows as numpy
    arrays on the host (float64 for the floating ones), rows first."""
    rows = torch.as_tensor(np.asarray(rows))
    ins, outs = {}, {}
    for key in chosen:
        s = snaps[key]
        for src, dst in ((s.inputs, ins), (s.outputs, outs)):
            for name, v in src.items():
                a = v.detach().cpu()[rows]
                dst.setdefault(name, []).append(
                    a.to(torch.float64).numpy() if a.is_floating_point()
                    else a.numpy())
    cat = lambda d: {k: np.concatenate(v) for k, v in d.items()}
    return cat(ins), cat(outs)


def end_to_end(result: W.Result, batch: int, setup_s: float) -> Dict[str, float]:
    """Every end-to-end metric the loop can give, by name."""
    out = {"setup_s": setup_s,
           "scenario_ticks_per_s": batch * result.ticks / result.seconds,
           "tick_ms": result.seconds / result.ticks * 1e3}
    if result.tick_s:
        out["tick_p95_ms"] = float(np.percentile(np.asarray(result.tick_s),
                                                 95.0)) * 1e3
    return out


def run(cell: catalog.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, repo: str = catalog.REPO,
        fault: Optional[Callable] = None, log=None) -> Dict:
    """The result line's fields (without the check's stderr lines) of one
    run. ``t_start``: the process's start on the host clock (set-up counts
    from it). ``fault(step, buf) -> step``: a broken step in place of the
    program's (the harness's own tests and the calibration's planted
    faults).

    Either run measures the window; the traced one also traces a short
    stretch after it (the per-layer metrics), and on the ``graph`` route
    times the window's replays with CUDA events (the device's idle share
    between replays, free of the profiler's own cost)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    config, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.zeros(1, device=device)      # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    setup = program.controller(config, traffic, repo, device)
    starts = _starts(setup, traffic, seed)
    buf, step = program.capture(setup, traffic, _first_buffers(starts))
    route = traffic["route"]
    log(f"route: {route}; captured: {step.graph is not None}; kernel "
        f"launches a replay {step.launches}")
    if fault is not None:
        step = fault(step, buf)
    K, B = traffic["chain_ticks"], traffic["batch"]
    W.run(buf, step, starts, traffic, trf.nothing(seed), max_chains=1,
          max_ticks=min(K, 5))              # the first replays, untimed
    sync()
    setup_s = time.perf_counter() - t_start

    plan = trf.plan(traffic, seed, K)
    result = W.run(buf, step, starts, traffic, plan, seconds=seconds,
                   events=traced and route == "graph")
    if traced:
        tcfg = traffic["trace"]
        stretch, summary = tr.profile(lambda span: W.run(
            buf, step, starts, traffic, trf.nothing(seed),
            max_chains=max(1, tcfg["chains"]),
            max_ticks=tcfg["ticks"] or None, span=span))
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    chosen = plan.choose(sorted(result.snapshots))
    ins, outs = stack(result.snapshots, chosen, plan.rows)
    result = result._replace(snapshots=None)
    del step, buf, starts, setup
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ReferenceTick(config, traffic, repo, device,
                        program.DTYPES[config["dtype"]])
    want = ref(ins["t"], ins["x"], ins["xs"], ins["us"])
    gaps = compare.gaps(outs, want)
    ok, checks = compare.judge(gaps, cell.limits)
    log(f"reference: {len(chosen)} ticks "
        f"({sum(k == 0 for _, k in chosen)} chain starts), "
        f"{ins['x'].shape[0]} rows, {time.perf_counter() - t_ref:.1f} s; "
        "gaps " + " ".join(f"{k}={v!r}" for k, v in gaps.items()))
    err = health.tracking_error(ref.state_ref, ref.dt_ref, outs["t"],
                                outs["x"])
    log(f"health of the compared rows: tracking error mean "
        f"{float(err.mean()):.4f} m, max {float(err.max()):.4f} m; "
        f"feasible {float(np.mean(outs['feasible'])):.4f}")

    costs = result.records[:, 0]
    line = {"correct": ok, "attempted": int(B * result.ticks),
            "failed": int(np.sum(~np.isfinite(costs))),
            "metrics": {}, "device": device_info(device, peak)}
    log(f"window: {result.ticks} ticks in {result.chains} chains, "
        f"{result.seconds:.3f} s; feasible "
        f"{float(np.mean(result.records[:, 1])):.6f} of scenario-ticks")
    log("chains (s): " + " ".join(f"{v:.3f}" for v in result.chain_s))
    if result.tick_s:
        q = np.percentile(np.asarray(result.tick_s) * 1e3, [0, 5, 50, 95, 100])
        log("round trips (ms): min, p5, p50, p95, max "
            + " ".join(f"{v:.3f}" for v in q))
    if traced:
        word = torch.finfo(program.DTYPES[config["dtype"]]).bits // 8
        shape = layers.shapes(ref.ctrl.spec, ref.settings.solver.n_alphas,
                              word, B)
        peaks = catalog.read_json(f"{catalog.BENCH_DIR}/peaks.json").get(
            line["device"]["kind"])
        ctx = layers.Context(summary, stretch.ticks,
                             int(stretch.records[:, 2].sum()), shape, peaks,
                             config["dtype"], result)
        for m in cell.per_layer:
            v = catalog.module("metrics", m["name"]).read(ctx)
            if v is not None:
                line["metrics"][m["name"]] = {"value": float(v),
                                              "unit": m["unit"]}
        line["device"]["busy_s"] = summary.busy_s
        line["device"]["window_s"] = summary.window_s
        log(f"traced stretch: {stretch.ticks} ticks, busy {summary.busy_s!r}"
            f" of {summary.window_s!r} s")
        top = sorted(summary.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        line["breakdown"] = {"device_ops": [[n, s] for n, (s, _) in top],
                             "idle_gaps": [[n, s] for n, s in summary.gaps]}
    else:
        values = end_to_end(result, B, setup_s)
        for m in cell.end_to_end:
            line["metrics"][m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
    line["route"] = route
    line["checks"] = checks
    return line
