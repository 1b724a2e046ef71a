"""The batch study's health arithmetic (as ``bench.py`` reads it): how far
the plant's position lies from the offline reference's at the same
mission time."""

from __future__ import annotations

import numpy as np


def ref_pos(ref: np.ndarray, dt_ref: float, t_ms: float) -> np.ndarray:
    """The offline reference's position (3,) at ``t_ms``: linear between
    its samples ``dt_ref`` ms apart, its last sample past its end."""
    t_ref = np.arange(ref.shape[0], dtype=np.float64) * dt_ref
    i = int(np.searchsorted(t_ref, t_ms, side="right"))
    if i >= len(t_ref):
        return ref[-1, :3]
    i1 = max(i, 1)
    a = (t_ms - t_ref[i1 - 1]) / (t_ref[i1] - t_ref[i1 - 1])
    return (1 - a) * ref[i1 - 1, :3] + a * ref[i1, :3]


def tracking_error(ref: np.ndarray, dt_ref: float, t_ms: np.ndarray,
                   x: np.ndarray) -> np.ndarray:
    """Distance (m) of each row's position ``x[:, :3]`` from the
    reference's at its time ``t_ms``."""
    want = np.stack([ref_pos(ref, dt_ref, float(t)) for t in t_ms])
    return np.linalg.norm(x[:, :3] - want, axis=1)
