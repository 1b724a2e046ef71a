"""What a per-layer reader (``metrics/<name>.py``, a function
``read(ctx) -> float or None``) reads: the traced stretch's summary, the
ticks and solver iterations in it, the tick's logical shapes and the card's
published peaks. A reader that finds nothing to read returns None and the
metric is left out of the line."""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

from . import catalog
from . import trace as tr


def shapes(spec, n_alphas: int, word: int, batch: int) -> Dict:
    """The tick's logical shapes from a problem spec (the reference's): per
    node and per problem, independent of any kernel's layout."""
    from ..reference.ocp import costs as C
    from ..reference.ocp import problem as P

    slots = spec.slots
    n_res = sum(s.nr for s in slots)
    nu = spec.nu
    return {
        "B": batch, "T": spec.T, "nx": spec.model.nx, "nq": spec.model.nq,
        "nv": spec.model.nv, "ndx": spec.state.ndx, "nu": nu,
        "n_slots": len(slots), "n_res": n_res,
        "n_state": sum(s.kind == C.STATE for s in slots),
        "n_frame": sum(s.nr for s in slots if s.kind in C.REF_DIMS),
        "nc": spec.nc_rows, "rk4": spec.integrator == P.RK4, "A": n_alphas,
        "word": word,
        # parameters: per node weight, activity and references of every
        # slot; per problem the activation weights and bounds of every
        # residual, the squash smoothness and the control bounds
        "node_dim": 2 * len(slots) + sum(s.ref_dim for s in slots),
        "glob_dim": 3 * n_res + 1 + 2 * nu,
    }


def kernels() -> Dict[str, object]:
    """Every kernel's work module (``work/*.py``) by name."""
    names = sorted(os.path.basename(p)[:-3] for p in
                   glob.glob(os.path.join(catalog.BENCH_DIR, "work", "*.py")))
    return {n: catalog.module("work", n) for n in names}


class Context:
    """``summary``: the traced stretch; ``ticks``: ticks in it;
    ``iterations``: solver iterations that did work in it, summed over the
    scenarios (each tick's ``iters``); ``shape``: :func:`shapes`;
    ``peaks``: the card's entry of ``peaks.json`` (None if it has none);
    ``window``: the run's untraced window (``window.Result``; its
    ``replay_s`` the replays' device spans where they were timed)."""

    def __init__(self, summary: tr.Summary, ticks: int, iterations: int,
                 shape: Dict, peaks: Optional[Dict], dtype: str,
                 window=None):
        self.summary, self.ticks, self.iterations = summary, ticks, iterations
        self.shape, self.peaks, self.dtype = shape, peaks, dtype
        self.window = window
        self.kernels = kernels()

    def device_s(self, names) -> float:
        """Device seconds of the operations whose name holds any of
        ``names``."""
        return sum(s for n, (s, _) in self.summary.by_name.items()
                   if any(k in n for k in names))

    def kernel_s(self, kernel: str) -> float:
        return self.device_s(self.kernels[kernel].DEVICE_NAMES)

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """100 x the least time of the work these ticks needed of
        ``kernel`` over its device time: the larger of bytes over the
        card's memory rate and operations over its rate in the tick's
        dtype."""
        t = self.kernel_s(kernel)
        if t <= 0 or self.peaks is None or self.iterations <= 0:
            return None
        flops, nbytes = self.kernels[kernel].work(self.shape, self.iterations)
        least = max(nbytes / self.peaks["bytes_s"],
                    flops / self.peaks["flops"][self.dtype])
        return 100.0 * least / t

    def plain_s(self) -> float:
        """Device seconds of every operation that is none of the kernels."""
        names = [n for m in self.kernels.values() for n in m.DEVICE_NAMES]
        return sum(s for n, (s, _) in self.summary.by_name.items()
                   if not any(k in n for k in names))
