"""The MPC tick captured in CUDA graphs.

The JAX package serves its tick as one compiled program (``jax.jit`` of
update, solve and plant; the serving bench chains K ticks in a
``lax.scan``). PyTorch's counterpart is a CUDA graph over static buffers:
the tick's fixed-depth route with ``sync_free=True`` reads nothing on the
host, so its kernels (K1, K2 and K3 among them) can be recorded once and
replayed with no Python in the loop.

- :class:`CapturedStep`: a closure over static tensors, warmed up eagerly on
  a side stream (which also fills the kernels' descriptor caches and the
  model's constants), then captured with ``torch.cuda.graph`` and replayed.
  The warm-up's second call, and the capture, run under
  ``torch.cuda.set_sync_debug_mode("error")``, so a host read or a pageable
  copy in the tick raises there. A failed capture or replay raises; there
  is no eager fallback on CUDA. On a CPU device (the tests) ``replay``
  calls the closure eagerly.
- :func:`serving_tick`: one whole tick (``update_problem``, the sync-free
  fixed solve, ``AerialSimulator.step``) that writes its results back into
  its inputs (x, xs, us, t += period), so replays in a row chain ticks on
  the device.
- :func:`capture_split`: the same tick as two captured steps, the update
  and then the solve with the plant, so that a real-time loop can time
  them apart.

Kernel launches inside a graph do not pass through the wrappers' Python
counters; ``CapturedStep.launches`` holds the launches each kernel's
wrapper made while the step was captured, which every replay repeats.
Likewise, with ``utils.spans`` on at the capture, the spans and counters
inside the tick are captured (``spans.capture``); the replays of such a
graph, and every replay while the spans are on, go through
``spans.replay``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Sequence

import torch

from ..ocp import problem as P
from ..ops import node_cuda, riccati_cuda, rollout_cuda
from ..utils import spans

KERNEL_COUNTERS = {"node_linearization": node_cuda,
                   "riccati_backward": riccati_cuda,
                   "alpha_rollout": rollout_cuda}


class CapturedStep:
    """``fn()`` captured once and replayed: ``fn`` reads and writes static
    tensors it closes over and returns its outputs (a tensor or a
    NamedTuple of tensors). ``state``: the tensors ``fn`` writes, restored
    after the warm-up so that the first replay starts where the caller
    left them. ``device``: where the tensors live."""

    def __init__(self, fn: Callable, device, state: Sequence = ()):
        self.fn = fn
        self.graph = None
        self.outputs = None
        self.launches = {}
        device = torch.device(device)
        if device.type != "cuda":
            return
        saved = [a.clone() for a in state]
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()                 # fills the caches: pageable copies allowed
            with _sync_error():
                fn()
        main.wait_stream(side)
        for a, s in zip(state, saved):
            a.copy_(s)
        before = {n: m.LAUNCHES for n, m in KERNEL_COUNTERS.items()}
        self.graph = torch.cuda.CUDAGraph()
        with spans.capture() as self.traced:
            with torch.cuda.graph(self.graph):
                with _sync_error():
                    self.outputs = fn()
        self.launches = {n: m.LAUNCHES - before[n]
                         for n, m in KERNEL_COUNTERS.items()}

    def replay(self):
        """Run the step once; returns its outputs (on CUDA the same static
        tensors every time)."""
        if self.graph is None:
            self.outputs = self.fn()
        elif spans.on() or self.traced.instrumented:
            spans.replay(self.graph, self.traced)
        else:
            self.graph.replay()
        return self.outputs


@contextlib.contextmanager
def _sync_error():
    """``torch.cuda.set_sync_debug_mode("error")`` for a block."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class TickBuffers(NamedTuple):
    """The static state of a served tick: mission time (B,) in ms, plant
    states (B, nx), warm-start candidates (B, T+1, nx) and (B, T, nu)."""

    t: torch.Tensor
    x: torch.Tensor
    xs: torch.Tensor
    us: torch.Tensor

    def clone(self) -> "TickBuffers":
        return TickBuffers(*(a.clone() for a in self))


class TickOutputs(NamedTuple):
    u0: torch.Tensor         # (B, nu) the control applied to the plant
    cost: torch.Tensor       # (B,)
    iters: torch.Tensor      # (B,)
    feasible: torch.Tensor   # (B,)


def make_buffers(t_ms: float, x0, xs, us) -> TickBuffers:
    """Fresh static buffers (contiguous copies) from a start: x0 (B, nx),
    xs, us."""
    t = torch.full((x0.shape[0],), float(t_ms), dtype=x0.dtype,
                   device=x0.device)
    copy = lambda a: a.clone(memory_format=torch.contiguous_format)
    return TickBuffers(t, copy(x0), copy(xs), copy(us))


def _solve_and_step(ctrl, sim, settings, period_ms, params, buf: TickBuffers,
                    **route) -> TickOutputs:
    r = ctrl.solve(params, buf.xs, buf.us, settings=settings, **route)
    u0 = r.us_squash[:, 0]
    buf.x.copy_(sim.step(buf.x, u0))
    buf.xs.copy_(r.xs)
    buf.us.copy_(r.us)
    buf.t.add_(period_ms)
    return TickOutputs(u0=u0, cost=r.cost, iters=r.iters, feasible=r.feasible)


def serving_tick(ctrl, sim, settings, period_ms: float, buf: TickBuffers,
                 fixed: bool = True,
                 sync_free: bool = True) -> Callable[[], TickOutputs]:
    """One served tick over ``buf`` as a closure: ``update_problem`` at
    ``buf.t`` from the plant states ``buf.x``, ``ctrl.solve`` from
    ``buf.xs``/``buf.us`` (by default the fixed-depth solve's sync-free
    route; ``sync_free=False`` its eager route, ``fixed=False`` the
    while-loop solve, neither of which a graph can capture), the plant
    stepped with the first squashed control; the results written back (x,
    xs, us, t + ``period_ms``). ``settings``: the solve's
    ``SbFddpSettings``. With ``utils.spans`` on, a call begins a tick."""
    params0 = P.expand_params(ctrl.params0, buf.x.shape[0])

    def tick():
        spans.tick()
        with spans.span("mpc.update"):
            params = ctrl.update_problem(buf.t, params0._replace(x0=buf.x))
        return _solve_and_step(ctrl, sim, settings, period_ms, params, buf,
                               fixed=fixed, sync_free=sync_free)
    return tick


def capture_split(ctrl, sim, settings, period_ms: float, buf: TickBuffers):
    """The served tick as two :class:`CapturedStep` s, replayed in turn once
    per tick: (the update ``() -> params``, the sync-free solve and the
    plant step ``() -> TickOutputs``, which reads the update's outputs and
    writes back as :func:`serving_tick` does)."""
    params0 = P.expand_params(ctrl.params0, buf.x.shape[0])
    device = buf.x.device

    def update_problem():
        spans.tick()
        with spans.span("mpc.update"):
            return ctrl.update_problem(buf.t, params0._replace(x0=buf.x))

    update = CapturedStep(update_problem, device)
    update.replay()      # the solve's warm-up and capture read its outputs
    solve = CapturedStep(
        lambda: _solve_and_step(ctrl, sim, settings, period_ms,
                                update.outputs, buf, fixed=True,
                                sync_free=True), device, state=buf)
    return update, solve
