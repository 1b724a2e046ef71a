"""The measured loop: chains of served ticks replayed from the captured
graph, with the host hop that the traffic mix asks for.

``host_hop: tick`` (a robot's controller): each tick copies the plant
state up into the graph's buffer, replays the graph and fetches u0 and the
plant's next state, so a tick starts only after the previous tick's u0 has
come back; each tick's round trip is timed on the host clock.

``host_hop: chain`` (a batch study): a chain's replays run back to back
and the costs, feasible flags and iterations of every tick are fetched
once, at the chain's end.

Either way each tick's cost, feasible flags and iterations are copied on
the device into a record that is fetched at the chain's end, and the
ticks of the sample plan are snapshotted (their inputs before the replay,
their outputs after it) outside the round trip's timing. With ``events``
each replay lies between two CUDA events, and the sum of their spans is
returned: the device's time inside replays, against the loop's wall time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import traffic as tr

OUTPUT_FIELDS = ("u0", "cost", "feasible", "iters")


class Snapshot(NamedTuple):
    inputs: Dict[str, torch.Tensor]    # t, x, xs, us before the tick
    outputs: Dict[str, torch.Tensor]   # t, x, xs, us after it; u0, cost, ...


class Result(NamedTuple):
    seconds: float          # the loop's length on the host clock
    ticks: int              # ticks completed (each over the whole batch)
    chains: int             # chains begun
    tick_s: List[float]     # each tick's round trip (host_hop tick only)
    chain_s: List[float]    # each chain's seconds, its reset and fetch in
    records: np.ndarray     # (ticks, 3, B): cost, feasible, iters
    snapshots: Dict[Tuple[int, int], Snapshot]
    replay_s: Optional[float]  # the replays' device spans (``events`` only)


class Starts(NamedTuple):
    """Where each chain begins: x0 of every drawn chain on the device and on
    the host (the sensor's first reading), and the candidates (a warm start
    shared by every chain, or None: x0 tiled and ``hover_us``)."""

    x_dev: torch.Tensor            # (n, B, nx)
    x_host: torch.Tensor           # (n, B, nx) on the CPU
    warm_xs: Optional[torch.Tensor]
    warm_us: Optional[torch.Tensor]
    hover_us: torch.Tensor         # (T, nu)
    t0_ms: float


def _clone(buf) -> Dict[str, torch.Tensor]:
    return {"t": buf.t.clone(), "x": buf.x.clone(), "xs": buf.xs.clone(),
            "us": buf.us.clone()}


def _reset(buf, starts: Starts, chain: int) -> None:
    i = chain % starts.x_dev.shape[0]
    buf.t.fill_(starts.t0_ms)
    buf.x.copy_(starts.x_dev[i])
    if starts.warm_xs is not None:
        buf.xs.copy_(starts.warm_xs)
        buf.us.copy_(starts.warm_us)
    else:
        buf.xs.copy_(starts.x_dev[i][:, None].expand_as(buf.xs))
        buf.us.copy_(starts.hover_us.expand_as(buf.us))


def run(buf, step, starts: Starts, traffic: Dict, plan: tr.Plan,
        seconds: float = float("inf"), max_chains: Optional[int] = None,
        max_ticks: Optional[int] = None,
        span: Callable[[str], object] = None, events: bool = False) -> Result:
    """Chains of ticks until ``seconds`` have passed (at a tick boundary
    under ``host_hop: tick``, at a chain's end under ``chain``), and never
    before the plan's sample is complete; or until ``max_chains`` chains /
    ``max_ticks`` ticks. ``span(name)``: a context manager around each step
    of the loop (the traced run's annotations). ``events``: time each
    replay on the device (CUDA only)."""
    span = span or (lambda name: contextlib.nullcontext())
    K, hop = traffic["chain_ticks"], traffic["host_hop"]
    if hop not in ("tick", "chain"):
        raise ValueError(f"host_hop must be tick or chain, got {hop!r}")
    B = buf.x.shape[0]
    rec = torch.zeros((K, 3, B), dtype=buf.x.dtype, device=buf.x.device)
    sync = (torch.cuda.synchronize if buf.x.device.type == "cuda"
            else (lambda: None))
    records, tick_s, chain_s, snaps, marks = [], [], [], {}, []
    events = events and buf.x.device.type == "cuda"
    event = lambda: torch.cuda.Event(enable_timing=True)
    ticks = chains = 0
    sync()
    t_begin = time.perf_counter()

    def over(now):
        return ((now - t_begin >= seconds and plan.complete(snaps))
                or (max_ticks is not None and ticks >= max_ticks))

    done = False
    while not done and (max_chains is None or chains < max_chains):
        c = chains
        chains += 1
        t_chain = time.perf_counter()
        with span("mpcbench.reset"):
            _reset(buf, starts, c)
        x_h = starts.x_host[c % starts.x_host.shape[0]]
        n = 0
        for k in range(K):
            snap_in = _clone(buf) if (c, k) in plan.snaps else None
            if hop == "tick":
                t_a = time.perf_counter()
                with span("mpcbench.copy_in"):
                    buf.x.copy_(x_h)
                with span("mpcbench.replay"):
                    out = _replay(step, marks, event if events else None)
                with span("mpcbench.fetch"):
                    out.u0.cpu()
                    x_h = buf.x.cpu()
                tick_s.append(time.perf_counter() - t_a)
            else:
                with span("mpcbench.replay"):
                    out = _replay(step, marks, event if events else None)
            with span("mpcbench.record"):
                for j, f in enumerate(("cost", "feasible", "iters")):
                    rec[k, j].copy_(getattr(out, f))
            if snap_in is not None:
                with span("mpcbench.snapshot"):
                    snaps[(c, k)] = Snapshot(
                        snap_in, dict(_clone(buf), **{
                            f: getattr(out, f).clone() for f in OUTPUT_FIELDS}))
            ticks += 1
            n += 1
            if ((hop == "tick" and over(time.perf_counter()))
                    or (max_ticks is not None and ticks >= max_ticks)):
                done = True
                break
        with span("mpcbench.fetch"):
            records.append(rec[:n].cpu().numpy())
        chain_s.append(time.perf_counter() - t_chain)
        if hop == "chain" and over(time.perf_counter()):
            done = True
    sync()
    return Result(seconds=time.perf_counter() - t_begin, ticks=ticks,
                  chains=chains, tick_s=tick_s, chain_s=chain_s,
                  records=np.concatenate(records).astype(np.float64),
                  snapshots=snaps,
                  replay_s=(sum(a.elapsed_time(b) for a, b in marks) * 1e-3
                            if events else None))


def _replay(step, marks: List, event: Optional[Callable]):
    """``step.replay()``, between two recorded events where ``event``
    makes them."""
    if event is None:
        return step.replay()
    a, b = event(), event()
    a.record()
    out = step.replay()
    b.record()
    marks.append((a, b))
    return out
