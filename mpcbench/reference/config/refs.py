"""Offline reference states of a mission, as cached under ``missions/refs/``.

The cached files are written by ``tools/make_ref.py`` (an offline SbFDDP
solve in the JAX package). Reading them needs only numpy, so the port keeps
its own reader with the same fallback semantics: the cached solve when it
exists, else the synthetic two-axis glide from the mission's initial state.
"""

from __future__ import annotations

import os

import numpy as np

from .parser import _REPO_ROOT


def ref_path(robot: str, mission: str, dt_ms: int) -> str:
    return os.path.join(_REPO_ROOT, "missions", "refs",
                        f"{robot}__{mission}__dt{dt_ms}.npz")


def synthetic_ref(traj, dt_ms: int) -> np.ndarray:
    """The synthetic fallback reference: a gentle 2-axis glide from the
    mission's initial state."""
    n_ref = traj.duration // dt_ms + 1
    ref = np.tile(np.asarray(traj.initial_state), (n_ref, 1))
    ref[:, 0] = np.linspace(0.0, 2.0, n_ref)
    ref[:, 1] = np.linspace(0.0, 0.5, n_ref)
    return ref


def load_ref(robot: str, mission: str, dt_ms: int, traj=None,
             synthetic: bool = False):
    """Offline reference states for a mission: ``(xs (N, nx) float64,
    kind)`` with kind ``"offline"`` (the cached solve) or ``"synthetic"``
    (the glide; needs ``traj``)."""
    path = ref_path(robot, mission, dt_ms)
    if not synthetic and os.path.exists(path):
        with np.load(path) as z:
            return z["xs"].copy(), "offline"
    if traj is None:
        raise FileNotFoundError(
            f"no cached offline reference at {path} and no trajectory given "
            "for the synthetic fallback; run tools/make_ref.py first")
    return synthetic_ref(traj, dt_ms), "synthetic"
