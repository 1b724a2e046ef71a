"""The numbers that decide ``correct``: how far a tick's outputs lie from
the reference's, row by row.

A row's gap of a continuous output (``u0``, ``x``, ``xs``, ``us``) is the
largest absolute difference over the row's entries over the largest
absolute entry of the reference's row; of ``cost``, the absolute
difference over the reference's absolute cost. Each is held as the 90th
percentile over the compared rows (``u0_p90``, ...) and shown as the
worst row (``u0_max``, ...). ``t`` is the largest absolute difference of
the mission time after the tick (the time's write-back; exact).
``feasible`` and ``iters`` count the rows that differ. A row whose output
is not finite reads ``inf``.

Why a high quantile and not the worst row: a row's solve can be
undetermined at the configuration's precision (a line-search step length
or the polish that flips with the last bit, or a cold start from which two
iterations diverge), and then its gap swings between runs whatever the
program does. The 90th percentile lets a tenth of the rows be such, and
catches a fault on more than a tenth of them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

CONTINUOUS = ("u0", "x", "xs", "us")
#: the percentile of the rows' gaps that is held to a limit
QUANTILE = 90.0
TINY = np.finfo(np.float64).tiny


def _finite(d: np.ndarray) -> np.ndarray:
    return np.where(np.isfinite(d), d, np.inf)


def row_gaps(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]):
    """{name: (R,) gaps of each row} for the continuous outputs and cost."""
    out = {}
    for k in CONTINUOUS:
        g = np.asarray(got[k], np.float64).reshape(len(want[k]), -1)
        w = np.asarray(want[k], np.float64).reshape(len(want[k]), -1)
        scale = np.maximum(np.abs(w).max(axis=1), TINY)
        out[k] = _finite(np.abs(g - w).max(axis=1) / scale)
    g, w = np.asarray(got["cost"], np.float64), want["cost"]
    out["cost"] = _finite(np.abs(g - w) / np.maximum(np.abs(w), TINY))
    return out


def gaps(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """{name: gap} of ``got`` (the tick under test) against ``want`` (the
    reference), both dicts of arrays with rows first."""
    out = {}
    for k, d in row_gaps(got, want).items():
        out[k + "_p90"] = float(np.percentile(d, QUANTILE))
        out[k + "_max"] = float(np.max(d))
    d = np.abs(np.asarray(got["t"], np.float64) - want["t"])
    out["t"] = float(np.max(_finite(d)))
    for k in ("feasible", "iters"):
        out[k] = float(np.sum(np.asarray(got[k]).astype(np.float64)
                              != want[k].astype(np.float64)))
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number above its limit, or missing, fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, float("inf"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and bool(v <= limit)
    return ok, checks
