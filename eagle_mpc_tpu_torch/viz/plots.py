"""Matplotlib plotting suite (the PyTorch port's copy of
``eagle_mpc_tpu.viz.plots``, numpy and matplotlib only): state / control /
attitude / 3-D trajectory figures from solver or closed-loop logs, the
parity layer of the reference's ``eagle_mpc.utils.plots``. Headless-safe
(Agg backend when no display). Arrays are numpy; pass tensors through
``.cpu().numpy()``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

import matplotlib

if not os.environ.get("DISPLAY"):
    matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402


def quat_to_rpy(q, deg: bool = False):
    """(x, y, z, w) quaternion -> roll/pitch/yaw (reference q2e)."""
    x, y, z, w = np.moveaxis(np.asarray(q), -1, 0)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sp = np.clip(2 * (w * y - z * x), -1.0, 1.0)
    pitch = np.arcsin(sp)
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    rpy = np.stack([roll, pitch, yaw], axis=-1)
    return np.degrees(rpy) if deg else rpy


def _time(n, dt_s):
    return np.arange(n) * dt_s


def plot_states(xs, dt_s: float, nq: int, legend: Optional[Sequence[str]] = None):
    """Position / attitude (RPY) / linear / angular velocity, 4 stacked axes
    (PlotStates + PlotAttitude + PlotVelocity* rolled together)."""
    xs = np.asarray(xs)
    t = _time(len(xs), dt_s)
    fig, axs = plt.subplots(4, 1, sharex=True, figsize=(9, 10))
    axs[0].plot(t, xs[:, :3])
    axs[0].set_ylabel("position [m]")
    axs[0].legend(["x", "y", "z"], loc="upper right")
    axs[1].plot(t, quat_to_rpy(xs[:, 3:7], deg=True))
    axs[1].set_ylabel("attitude [deg]")
    axs[1].legend(["roll", "pitch", "yaw"], loc="upper right")
    axs[2].plot(t, xs[:, nq : nq + 3])
    axs[2].set_ylabel("v lin [m/s]")
    axs[3].plot(t, xs[:, nq + 3 : nq + 6])
    axs[3].set_ylabel("v ang [rad/s]")
    axs[3].set_xlabel("time [s]")
    fig.align_ylabels(axs)
    return fig


def plot_controls(us, dt_s: float, n_rotors: int,
                  legend: Optional[Sequence[str]] = None):
    """Rotor thrusts + joint torques over time (PlotControls)."""
    us = np.asarray(us)
    t = _time(len(us), dt_s)
    nj = us.shape[1] - n_rotors
    n_ax = 2 if nj else 1
    fig, axs = plt.subplots(n_ax, 1, sharex=True, figsize=(9, 3.2 * n_ax),
                            squeeze=False)
    axs[0, 0].plot(t, us[:, :n_rotors])
    axs[0, 0].set_ylabel("rotor thrust [N]")
    axs[0, 0].legend([f"r{i}" for i in range(n_rotors)], loc="upper right",
                     ncol=min(n_rotors, 6), fontsize=8)
    if nj:
        axs[1, 0].plot(t, us[:, n_rotors:])
        axs[1, 0].set_ylabel("joint torque [Nm]")
        axs[1, 0].legend([f"j{i}" for i in range(nj)], loc="upper right")
    axs[-1, 0].set_xlabel("time [s]")
    return fig


def plot_controls_group(us, dt_s: float, n_rotors: int, group: int = 6):
    """One subplot per group of rotors (reference PlotControlsGroup)."""
    us = np.asarray(us)
    t = _time(len(us), dt_s)
    n_groups = int(np.ceil(us.shape[1] / group))
    fig, axs = plt.subplots(n_groups, 1, sharex=True,
                            figsize=(9, 2.6 * n_groups), squeeze=False)
    for g in range(n_groups):
        sl = slice(g * group, min((g + 1) * group, us.shape[1]))
        axs[g, 0].plot(t, us[:, sl])
        axs[g, 0].legend([f"u{i}" for i in range(sl.start, sl.stop)],
                         loc="upper right", ncol=6, fontsize=8)
    axs[-1, 0].set_xlabel("time [s]")
    return fig


def plot_trajectory_3d(xs, waypoints=None, elev=None, azim=None):
    """3-D base-link path with optional waypoint markers
    (Plot3DTrajectory)."""
    xs = np.asarray(xs)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.plot(xs[:, 0], xs[:, 1], xs[:, 2], lw=1.5)
    ax.scatter(*xs[0, :3], color="green", label="start")
    ax.scatter(*xs[-1, :3], color="red", label="end")
    if waypoints is not None:
        wp = np.asarray(waypoints)
        ax.scatter(wp[:, 0], wp[:, 1], wp[:, 2], marker="^", color="k",
                   label="waypoints")
    if elev is not None or azim is not None:
        ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
    ax.legend()
    return fig


def plot_solver_telemetry(costs, iters=None, dt_s: Optional[float] = None):
    """Per-tick solver cost (and iteration count) of a closed-loop run —
    the observability layer the reference only had via CallbackVerbose."""
    costs = np.asarray(costs)
    t = _time(len(costs), dt_s) if dt_s else np.arange(len(costs))
    n_ax = 2 if iters is not None else 1
    fig, axs = plt.subplots(n_ax, 1, sharex=True, squeeze=False,
                            figsize=(9, 3 * n_ax))
    axs[0, 0].semilogy(t, np.maximum(costs, 1e-12))
    axs[0, 0].set_ylabel("solve cost")
    if iters is not None:
        axs[1, 0].plot(t, np.asarray(iters))
        axs[1, 0].set_ylabel("iterations")
    axs[-1, 0].set_xlabel("time [s]" if dt_s else "tick")
    return fig


def show():
    plt.show()


def save_fig(fig, name: str, dpi: int = 130):
    fig.savefig(name, dpi=dpi, bbox_inches="tight")
