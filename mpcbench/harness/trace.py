"""The traced run: a short steady stretch of the loop under
``torch.profiler`` (host and device activity), reduced to what the
per-layer readers need.

The stretch sits inside a ``mpcbench.window`` annotation; its length is the
traced window. Device busy time is the union of the device operations'
intervals inside it (kernels, copies and sets; the device's copies of the
annotations are left out), so overlapping operations count once. Idle gaps
are the holes of that union, each labelled by what the host was doing at
its middle: the harness's own step (``mpcbench.*``) and the innermost
host operation there.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

WINDOW = "mpcbench.window"
NAME_CHARS = 96


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: int
    by_name: Dict[str, Tuple[float, int]]   # device op -> (seconds, count)
    gaps: List[Tuple[str, float]]           # longest idle gaps, labelled


def profile(fn: Callable[[Callable[[str], object]], object]):
    """Run ``fn(span)`` under the profiler, ``span(name)`` an annotation;
    returns (fn's result, Summary)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn(record_function)
            if cuda:
                torch.cuda.synchronize()
    return out, summarize(prof.profiler.kineto_results.events(),
                          DeviceType.CUDA)


def summarize(events, device_type) -> Summary:
    """The Summary of kineto events (``start_ns``, ``duration_ns``,
    ``name``, ``device_type``, ``is_user_annotation``)."""
    host, dev, window = [], [], None
    for e in events:
        a, d, name = e.start_ns(), e.duration_ns(), e.name()
        # the device's copies of the annotations are no device work
        ann = name.startswith("mpcbench.") or e.is_user_annotation()
        if e.device_type() == device_type:
            if not ann:
                dev.append((a, a + d, name))
        else:
            if name == WINDOW:
                window = (a, a + d)
            host.append((a, a + d, name))
    if window is None:
        raise RuntimeError("the traced window's annotation is missing")
    w0, w1 = window
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                 if b > w0 and a < w1)
    by_name: Dict[str, Tuple[float, int]] = {}
    for a, b, n in dev:
        key = n[:NAME_CHARS]
        s, c = by_name.get(key, (0.0, 0))
        by_name[key] = (s + (b - a) * 1e-9, c + 1)
    merged, holes = [], []
    cur = w0
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            if a > cur:
                holes.append((cur, a))
            merged.append([a, b])
        cur = max(cur, b)
    if cur < w1:
        holes.append((cur, w1))
    busy = sum(b - a for a, b in merged)
    longest = sorted(holes, key=lambda h: h[0] - h[1])[:10]
    gaps = [(_label(host, (a + b) // 2), (b - a) * 1e-9) for a, b in longest]
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                   device_ops=len(dev), by_name=by_name, gaps=gaps)


def _label(host, t) -> str:
    """What the host was doing at ``t``: the innermost harness step and the
    innermost other host operation around it."""
    inside = [(b - a, n) for a, b, n in host if a <= t < b and n != WINDOW]
    steps = sorted(x for x in inside if x[1].startswith("mpcbench."))
    ops = sorted(x for x in inside if not x[1].startswith("mpcbench."))
    parts = [steps[0][1] if steps else "mpcbench.other"]
    if ops:
        parts.append(ops[0][1][:NAME_CHARS])
    return " > ".join(parts)
