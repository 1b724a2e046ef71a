"""Motor-command conversion, mission state errors and result logs
(counterpart of ``eagle_mpc_tpu.utils.tools``), on numpy arrays."""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..config.specs import PlatformParams
from ..dynamics import lie


def thrust_to_speed(thrust, platform: PlatformParams):
    """Rotor thrust [N] -> prop angular speed [rad/s]: w = sqrt(T / cf)."""
    return np.sqrt(np.maximum(np.asarray(thrust, dtype=float), 0.0) / platform.cf)


def thrust_to_speed_normalized(thrust, platform: PlatformParams):
    """Thrust -> normalized [-1, 1] motor command over the platform's prop
    speed range."""
    w = thrust_to_speed(thrust, platform)
    lo, hi = platform.min_prop_speed, platform.max_prop_speed
    return (2.0 * w - (hi + lo)) / (hi - lo)


def state_error(x, x_ref, nq: int):
    """(pos err, rot err, vlin err, vang err) norms between two states."""
    x, x_ref = np.asarray(x, dtype=float), np.asarray(x_ref, dtype=float)
    e_pos = np.linalg.norm(x[:3] - x_ref[:3])
    R, Rr = (lie.quat_to_rot(torch.as_tensor(q[3:7], dtype=torch.float64))
             for q in (x, x_ref))
    e_rot = float(torch.linalg.vector_norm(lie.log3(Rr.T @ R)))
    v, vr = x[nq:], x_ref[nq:]
    e_vlin = np.linalg.norm(v[:3] - vr[:3])
    e_vang = np.linalg.norm(v[3:6] - vr[3:6])
    return np.array([e_pos, e_rot, e_vlin, e_vang])


def mission_errors(xs, refs, nq: int):
    """Per-knot errors against a reference state sequence: (4, N) rows of
    ``state_error``."""
    return np.stack([state_error(x, r, nq) for x, r in zip(xs, refs)], axis=1)


def save_logfile(filename: str, xs, us, us_squash=None, dt: float = 0.0,
                 costs=None, iters=None, forces=None, extras: Optional[dict] = None):
    """Persist a solve or closed-loop log (a pickle of numpy arrays)."""
    arr = lambda a: None if a is None else np.asarray(a)
    data = {"xs": np.asarray(xs), "us": np.asarray(us),
            "us_squash": arr(us_squash), "dt": dt, "costs": arr(costs),
            "iters": arr(iters), "forces": arr(forces)}
    if extras:
        data.update(extras)
    with open(filename, "wb") as f:
        pickle.dump(data, f)


def load_logfile(filename: str) -> dict:
    """Read a log that ``save_logfile`` wrote (only files this program
    wrote: unpickling runs code)."""
    with open(filename, "rb") as f:
        return pickle.load(f)
