"""The port's spans and device counters: where a tick's time goes, and how
much of the launched solver work the data needed.

Off by default; a caller switches it on with :func:`enable` and collects
with :func:`take`. Nothing is written anywhere: records stay in memory.

A span (:class:`Span`) is a named phase of the program (:data:`NAMES`):
its parent span, the id of the tick it belongs to (:func:`tick`; a
``CapturedStep`` replay, or one call of the eager tick), its host start
and end (``time.perf_counter_ns``) and, on CUDA, its device time: the time
between two timing events recorded on the current stream
(``torch.cuda.Event(enable_timing=True, external=True)``). Inside a CUDA
graph capture the two events become nodes of the graph, so every replay
records them again; ``mpc.graph.CapturedStep`` hands its replays to
:func:`replay`, which reads a replay's times before the next replay of the
same graph overwrites them (by waiting on its last event), and such spans
have no host times. ``graph.launch``, the host's launch of a replay, is
recorded only for a graph captured with tracing off: event nodes make the
launch itself take about the graph's device time. On the eager route a span's device time also holds the
time the device waits while the host dispatches the phase. While
``torch.profiler`` is active a span is also a ``record_function``
annotation, on the trace's clock.

A counter pair (:data:`COUNTERS`) counts launched rows, fixed on the host
when the work is launched (at capture for a graph, added again at every
replay), and the rows among them that did work, summed on the device per
row without any read on the host, so a graph can capture it. A single
counter (:data:`SINGLE`) is summed on the device alone. The device
tensors exist only once tracing is on.

Backward passes: a K3 launch counts its B rows launched, and each active
row's passes as needed, its first and every retry of the regularization
escalation the kernel ran for it (so a launch can need more passes than it
has rows); ``backward.row_retries`` counts those retries alone. The
passes without a kernel count a launch per round of the host's escalation,
each over the rows that retry.

Spans of :data:`DETAIL` (the solver's inner phases and the three kernels'
wrappers) are recorded only with ``enable(detail=True)``
(``profile_tick.py``); the others always while tracing is on.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, NamedTuple, Optional

import torch

#: spans recorded whenever tracing is on (one per phase of the tick)
METRIC = ("mpc.update", "ocp.terminal", "sim.step", "solver.iteration",
          "solver.escalation", "graph.launch")
#: spans recorded only with ``enable(detail=True)`` (``profile_tick.py``)
DETAIL = ("solver.gaps", "solver.backward", "solver.line_search",
          "solver.expected_improvement", "k1", "k2", "k3")
NAMES = METRIC + DETAIL
#: counter pairs, (launched rows, rows that did work): backward passes
#: (K3 or the plain box pass) and solver iterations
PASSES = ("backward.row_passes", "backward.row_passes_needed")
ITERATIONS = ("solver.row_iterations", "solver.row_iterations_active")
COUNTERS = (PASSES, ITERATIONS)
#: single counters: the escalation's retries of the active rows
RETRIES = "backward.row_retries"
SINGLE = (RETRIES,)


class Span(NamedTuple):
    name: str
    parent: Optional[str]          # the enclosing span's name
    tick: int
    host_start_ns: Optional[int]   # None where a CUDA graph replayed it
    host_end_ns: Optional[int]
    device_ms: Optional[float]     # None off CUDA and for host-only spans


class Record(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]       # every name of COUNTERS
    ticks: int                     # ticks begun since the last take/reset


class Captured:
    """What one CUDA graph capture recorded: its spans' (name, parent, start
    event, end event) in the order they ended, the rows its counters
    launch at every replay, and whether the captured code began a tick
    (then so does every replay)."""

    def __init__(self):
        self.spans: List = []
        self.launched: Dict[str, int] = {}
        self.new_tick = False
        self.pending: Optional[int] = None    # tick of an unread replay

    @property
    def instrumented(self) -> bool:
        """Whether the capture recorded event or counter nodes."""
        return bool(self.spans or self.launched)


class _Recorder:
    """The process's tracing state (one per process: the program's phases
    are module functions)."""

    def __init__(self):
        self.on = False
        self.detail = False
        self.device_time = False
        self.tick_id = 0
        # (needed name, device, rows) -> tensor; never freed, since a
        # captured graph writes it at every replay
        self.rows: Dict = {}
        self._clear()

    def _clear(self):
        self.stack: List[_Open] = []
        self.done: List[Span] = []
        self.pending: List = []       # eager spans with unread events
        self.replays: List[Captured] = []
        self.capture: Optional[Captured] = None
        self.launched: Dict[str, int] = {}
        self.ticks = 0

    def capturing(self) -> bool:
        return self.device_time and torch.cuda.is_current_stream_capturing()


_R = _Recorder()
_OFF = contextlib.nullcontext()


def _event():
    return torch.cuda.Event(enable_timing=True, external=True)


class _Open:
    """An open span (the context manager :func:`span` returns)."""

    __slots__ = ("name", "device", "parent", "tick", "t0", "e0", "rf",
                 "captured")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        r = _R
        self.parent = r.stack[-1].name if r.stack else None
        self.tick = r.tick_id
        self.captured = r.capturing()
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.e0 = None
        if self.device and r.device_time:
            self.e0 = _event()
            self.e0.record()
        r.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        r = _R
        t1 = time.perf_counter_ns()
        e1 = None
        if self.e0 is not None:
            e1 = _event()
            e1.record()
        if r.stack and r.stack[-1] is self:
            r.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.captured:
            if r.capture is not None and e1 is not None:
                r.capture.spans.append((self.name, self.parent, self.e0, e1))
        elif e1 is not None:
            r.pending.append((self.name, self.parent, self.tick, self.t0, t1,
                              self.e0, e1))
        else:
            r.done.append(Span(self.name, self.parent, self.tick, self.t0,
                               t1, None))
        return False


def on() -> bool:
    """Whether tracing is on."""
    return _R.on


def enable(detail: bool = False) -> None:
    """Switch tracing on (device times where CUDA is available) from an
    empty record (:func:`reset`); with ``detail`` the spans of
    :data:`DETAIL` too. A graph captured before this records no spans or
    counters inside its replays."""
    reset()
    _R.on, _R.detail = True, detail
    _R.device_time = torch.cuda.is_available()


def disable() -> None:
    """Switch tracing off and drop what was not taken."""
    reset()
    _R.on = False


def span(name: str, device: bool = True):
    """A context manager around one phase ``name`` (of :data:`NAMES`);
    ``device=False`` records host times only. A shared no-op while tracing
    is off."""
    r = _R
    if not r.on or (not r.detail and name in DETAIL):
        return _OFF
    return _Open(name, device)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _R.on:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def tick() -> None:
    """Begin a tick: the spans that follow carry its id. Inside a capture
    the graph's replays will begin one each instead."""
    r = _R
    if not r.on:
        return
    if r.capturing():
        if r.capture is not None:
            r.capture.new_tick = True
        return
    r.tick_id += 1
    r.ticks += 1


def _device_rows(name: str, m: torch.Tensor) -> torch.Tensor:
    """The per-row device tensor of counter ``name`` (made on first use,
    outside a capture)."""
    r = _R
    key = (name, m.device, m.shape[0])
    rows = r.rows.get(key)
    if rows is None:
        if r.capturing():
            raise RuntimeError(f"counter {name} first used inside a CUDA "
                               "graph capture: run the step once before")
        rows = r.rows[key] = torch.zeros(m.shape[0], dtype=torch.int64,
                                         device=m.device)
    return rows


def _product(masks, values):
    m = masks[0]
    for k in masks[1:]:
        m = m & k
    return m if values is None else m * values


def count(pair, *masks: torch.Tensor, values=None) -> None:
    """Count one launch over the rows of the (B,) boolean ``masks`` in the
    counter ``pair`` (:data:`PASSES` or :data:`ITERATIONS`): B rows
    launched (on the host), and the rows where every mask holds (summed
    per row on the device), each as ``values`` (B,) ints where given,
    else as one."""
    r = _R
    if not r.on:
        return
    launched, needed = pair
    m = _product(masks, values)
    n = m.shape[0]
    _device_rows(needed, m).add_(m)
    if r.capturing():
        if r.capture is not None:
            r.capture.launched[launched] = r.capture.launched.get(launched,
                                                                  0) + n
    else:
        r.launched[launched] = r.launched.get(launched, 0) + n


def add(name: str, *masks: torch.Tensor, values=None) -> None:
    """Add to the single counter ``name`` (:data:`SINGLE`) the rows where
    every (B,) mask holds, each as ``values`` (B,) ints where given, else
    as one (summed per row on the device)."""
    if not _R.on:
        return
    m = _product(masks, values)
    _device_rows(name, m).add_(m)


@contextlib.contextmanager
def capture():
    """Around a CUDA graph's capture: yields the :class:`Captured` that
    :func:`replay` takes (empty while tracing is off)."""
    cap = Captured()
    r = _R
    if not r.on:
        yield cap
        return
    outer, r.capture = r.capture, cap
    try:
        yield cap
    finally:
        r.capture = outer


def replay(graph, cap: Captured) -> None:
    """``graph.replay()`` while tracing is on, or of a graph whose capture
    recorded nodes (``cap.instrumented``): adds the launched rows, which
    the graph's counter nodes count whether tracing is on or not. While it
    is on, also reads the previous replay's span times first, begins a
    tick where the captured code began one and, for a graph without
    nodes, times the launch on the host (``graph.launch``)."""
    r = _R
    if not r.on:
        graph.replay()
    else:
        _read_replay(cap)
        if cap.new_tick:
            tick()
        launch = (_OFF if cap.instrumented
                  else span("graph.launch", device=False))
        with launch:
            graph.replay()
        if cap.spans:
            cap.pending = r.tick_id
            if cap not in r.replays:
                r.replays.append(cap)
    for name, n in cap.launched.items():
        r.launched[name] = r.launched.get(name, 0) + n


def _read_replay(cap: Captured) -> None:
    if cap.pending is None:
        return
    cap.spans[-1][3].synchronize()
    _R.done.extend(Span(name, parent, cap.pending, None, None,
                        e0.elapsed_time(e1))
                   for name, parent, e0, e1 in cap.spans)
    cap.pending = None


def reset() -> None:
    """Drop every record and zero the counters (in stream order: work
    enqueued before counts no more)."""
    r = _R
    for cap in r.replays:
        cap.pending = None
    for rows in r.rows.values():
        rows.zero_()
    r._clear()


def take() -> Record:
    """Every span since the last take or reset (waiting for the device
    where a time is not read yet) and the counters, then reset."""
    r = _R
    for cap in r.replays:
        _read_replay(cap)
    if r.pending:
        torch.cuda.synchronize()
    spans = r.done + [Span(n, p, t, a, b, e0.elapsed_time(e1))
                      for n, p, t, a, b, e0, e1 in r.pending]
    spans.sort(key=lambda s: s.tick)
    counters = {name: 0 for name in sum(COUNTERS, ()) + SINGLE}
    counters.update(r.launched)
    for (name, _, _), rows in r.rows.items():
        counters[name] += int(rows.sum())
    out = Record(spans=spans, counters=counters, ticks=r.ticks)
    reset()
    return out
