"""Matplotlib 3-D multicopter display: thrust arrows, frame axes, CoG trace
(counterpart of ``eagle_mpc_tpu.viz.visualizer``).

A stand-in for the reference's Gepetto-viewer display
(``MulticopterMpcDisplay``): the same visual vocabulary (per-rotor thrust
arrows scaled by the commanded thrust, operational-frame axes, an optional
payload marker and a CoG trace) rendered headlessly with matplotlib.
``display`` renders a trajectory as key frames into one 3-D axes;
``animate`` produces a ``FuncAnimation`` for export. The bodies' and the
frames' placements come from the port's ``dynamics.rbd`` in float64 on the
CPU, and the base's rotation from its quaternion (x, y, z, w) by
``dynamics.lie.quat_to_rot``, the rotation ``rbd`` uses. (The JAX
package's display reads the quaternion as (w, x, y, z) at this one place,
so it draws the airframe and its rotors turned; its CoG and frame axes
come from its ``rbd`` and agree with these.)

Rotor geometry is recovered from the allocation matrix: column i of
``tau_f`` is [d_i ; p_i x d_i + spin_i (cm/cf) d_i] with |d_i| = 1, so
spin_i (cm/cf) = t_i . d_i and the rotor position (perpendicular to the
thrust axis, which is all a drawing needs) is d_i x (t_i - (t_i . d_i) d_i).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config.specs import PlatformParams
from ..dynamics import lie, rbd
from ..dynamics.model import RobotModel
from .plots import quat_to_rpy  # noqa: F401  (re-export for convenience)


def rotor_geometry(platform: PlatformParams):
    """(positions (n,3), thrust directions (n,3), spins (n,)) from tau_f."""
    tau_f = np.asarray(platform.tau_f, dtype=np.float64)
    d = tau_f[:3].T                                   # (n, 3) unit thrust dirs
    t = tau_f[3:].T                                   # (n, 3) torque columns
    k = np.sum(t * d, axis=1)                         # spin * cm/cf
    spins = np.sign(k)
    pxd = t - k[:, None] * d                          # p x d
    pos = np.cross(d, pxd)                            # perp component of p
    return pos, d, spins


def _host(a):
    return a.numpy()


class MulticopterDisplay:
    """Render closed-loop rollouts of a multicopter(+arm) platform. States
    are numpy arrays (or CPU tensors) with the quaternion (x, y, z, w) at
    3:7."""

    def __init__(self, model: RobotModel, platform: PlatformParams,
                 frame_names: Sequence[str] = (),
                 payload: bool = False, cog: bool = False,
                 thrust_arrow_length: float = 0.5):
        self.model = model
        self.platform = platform
        self.rotor_pos, self.rotor_dir, self.rotor_spin = \
            rotor_geometry(platform)
        self.thrust_range = platform.max_thrust - platform.min_thrust
        self.thrust_arrow_length = thrust_arrow_length
        self.frame_ids = [model.frame_id(n) for n in frame_names]
        self.payload = payload
        self.cog = cog

    # -- geometry ----------------------------------------------------------
    def _q(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)[: self.model.nq])

    def _base_pose(self, x):
        x = np.asarray(x, dtype=np.float64)
        return x[:3], _host(lie.quat_to_rot(torch.as_tensor(x[3:7])))

    def _world_rotors(self, x):
        p, R = self._base_pose(x)
        return p + self.rotor_pos @ R.T, self.rotor_dir @ R.T

    def _cog_world(self, x):
        pw, Rw = rbd.body_world_placements(self.model, self._q(x))
        m_tot, c = 0.0, np.zeros(3)
        for b in range(self.model.nj + 1):
            I6 = np.asarray(self.model.inertia[b], dtype=np.float64)
            m = I6[0, 0]
            mc = np.array([I6[5, 1], I6[3, 2], I6[4, 0]])
            com_local = mc / m if m > 0 else np.zeros(3)
            c = c + m * (_host(pw[b]) + _host(Rw[b]) @ com_local)
            m_tot += m
        return c / max(m_tot, 1e-12)

    def _frame_poses(self, x):
        """World (p, R) of each displayed operational frame."""
        q = self._q(x)
        return [tuple(map(_host, rbd.frame_placement(self.model, q, fid)))
                for fid in self.frame_ids]

    # -- drawing -----------------------------------------------------------
    def _draw_frame(self, ax, x, u=None, alpha=1.0):
        p, R = self._base_pose(x)
        rp, rd = self._world_rotors(x)
        # airframe: arms from base to each rotor
        for i in range(len(rp)):
            ax.plot([p[0], rp[i, 0]], [p[1], rp[i, 1]], [p[2], rp[i, 2]],
                    color="0.35", lw=1.2, alpha=alpha)
        ax.scatter(rp[:, 0], rp[:, 1], rp[:, 2], color="0.2", s=8,
                   alpha=alpha, depthshade=False)
        # thrust arrows (magenta, scaled by u / thrust range)
        if u is not None:
            u = np.asarray(u, dtype=np.float64)
            scale = (np.clip(u[: len(rp)] - self.platform.min_thrust, 0.0,
                             None) / max(self.thrust_range, 1e-12))
            vec = rd * (scale[:, None] * self.thrust_arrow_length)
            ax.quiver(rp[:, 0], rp[:, 1], rp[:, 2],
                      vec[:, 0], vec[:, 1], vec[:, 2],
                      color="m", alpha=alpha, arrow_length_ratio=0.15)
        # operational frame axes
        for fp, fR in self._frame_poses(x):
            for k, color in enumerate("rgb"):
                axis = fR[:, k] * 0.12
                ax.plot([fp[0], fp[0] + axis[0]], [fp[1], fp[1] + axis[1]],
                        [fp[2], fp[2] + axis[2]], color=color, lw=1.5,
                        alpha=alpha)
        if self.payload:
            ax.scatter([p[0]], [p[1]], [p[2] - 0.08], color="tab:blue",
                       s=45, alpha=alpha, depthshade=False)

    def display(self, xs, us=None, n_frames: int = 8, elev=None, azim=None):
        """Static figure: trajectory line + n_frames ghosted airframes."""
        import matplotlib.pyplot as plt

        xs = np.asarray(xs)
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        ax.plot(xs[:, 0], xs[:, 1], xs[:, 2], color="tab:blue", lw=1.0)
        idxs = np.unique(np.linspace(0, len(xs) - 1, n_frames).astype(int))
        for j, i in enumerate(idxs):
            alpha = 0.25 + 0.75 * (j + 1) / len(idxs)
            u = None if us is None or i >= len(us) else us[i]
            self._draw_frame(ax, xs[i], u, alpha=alpha)
        if self.cog:
            cogs = np.array([self._cog_world(x) for x in xs[idxs]])
            ax.plot(cogs[:, 0], cogs[:, 1], cogs[:, 2], "k.", ms=3)
        ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]"), ax.set_zlabel("z [m]")
        if elev is not None or azim is not None:
            ax.view_init(elev=elev, azim=azim)
        ax.set_box_aspect((1, 1, 0.7))
        fig.tight_layout()
        return fig, ax

    def animate(self, xs, us=None, dt_ms: float = 30.0, stride: int = 1,
                elev=None, azim=None):
        """FuncAnimation of the rollout (save with .save('out.mp4'/'.gif'))."""
        import matplotlib.pyplot as plt
        from matplotlib import animation

        xs = np.asarray(xs)[::stride]
        us_s = None if us is None else np.asarray(us)[::stride]
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        lims = (xs[:, :3].min(axis=0) - 0.5, xs[:, :3].max(axis=0) + 0.5)

        def frame(i):
            ax.cla()
            ax.plot(xs[: i + 1, 0], xs[: i + 1, 1], xs[: i + 1, 2],
                    color="tab:blue", lw=1.0)
            u = None if us_s is None or i >= len(us_s) else us_s[i]
            self._draw_frame(ax, xs[i], u)
            ax.set_xlim(lims[0][0], lims[1][0])
            ax.set_ylim(lims[0][1], lims[1][1])
            ax.set_zlim(lims[0][2], lims[1][2])
            if elev is not None or azim is not None:
                ax.view_init(elev=elev, azim=azim)
            return []

        return animation.FuncAnimation(
            fig, frame, frames=len(xs), interval=dt_ms * stride, blit=False)
