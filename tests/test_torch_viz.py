"""The PyTorch port's ``viz`` against the JAX package's: rotor geometry and
RPY on every platform preset, the multicopter display's geometry at the
flagship offline reference's states (tests/fixtures/torch_port_serving.npz,
``disp_*``), the figures' line data, the display and the animation drawn
headless, and ``--plot`` on the closed-loop and offline entry points. The
JAX functions compared here are plain numpy; no JAX function is
compiled."""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from eagle_mpc_tpu.config import specs  # noqa: E402
from eagle_mpc_tpu.utils import aerial_manipulation as jax_am  # noqa: E402
from eagle_mpc_tpu.viz import plots as jax_plots  # noqa: E402
from eagle_mpc_tpu.viz import visualizer as jax_vis  # noqa: E402
from eagle_mpc_tpu_torch import config  # noqa: E402
from eagle_mpc_tpu_torch.dynamics import lie  # noqa: E402
from eagle_mpc_tpu_torch.mpc import __main__ as mpc_main  # noqa: E402
from eagle_mpc_tpu_torch import trajectory as traj_main  # noqa: E402
from eagle_mpc_tpu_torch.utils import aerial_manipulation as am  # noqa: E402
from eagle_mpc_tpu_torch.viz import (MulticopterDisplay, plots,  # noqa: E402
                                     rotor_geometry)

from torch_port_util import FLAGSHIP, MISSIONS, load_port  # noqa: E402

SERVING_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                               "torch_port_serving.npz")
ROBOTS = sorted(r for r in os.listdir(MISSIONS)
                if os.path.exists(os.path.join(MISSIONS, r, "mpc", "mpc.yaml")))
TOL = 1e-12


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(SERVING_FIXTURE))


def _platforms(name):
    """(JAX platform, port platform) of a mission robot or a preset."""
    if name == "hexarotor370_params":
        return jax_am.hexarotor370_params(), am.hexarotor370_params()
    if name == "hexarotor680_params":
        return jax_am.hexarotor680_params(), am.hexarotor680_params()
    path = f"{name}/mpc/mpc.yaml"
    return (specs.load_mpc_params(path, yaml_dir=MISSIONS).platform,
            config.load_mpc_params(path, yaml_dir=MISSIONS).platform)


@pytest.mark.parametrize("name", ROBOTS + ["hexarotor370_params",
                                           "hexarotor680_params"])
def test_rotor_geometry_and_rpy(name):
    jp, tp = _platforms(name)
    for a, b in zip(jax_vis.rotor_geometry(jp), rotor_geometry(tp)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for deg in (False, True):
        np.testing.assert_array_equal(plots.quat_to_rpy(q, deg),
                                      jax_plots.quat_to_rpy(q, deg))


def test_display_geometry_matches_jax(fx):
    """At the flagship offline reference's states: the CoG and the gripper's
    and base link's placements equal the JAX display's to 1e-12. The base
    rotation is ``rbd``'s in both packages (the fixture's ``R_rbd``), and
    the rotors follow from it. The JAX display draws the base with the
    quaternion read as (w, x, y, z): its rotation is that of the
    quaternion rolled by one place, which this port does not copy."""
    traj, mp = load_port(FLAGSHIP)
    ref = np.load(os.path.join(MISSIONS, "refs",
                               f"{FLAGSHIP}__displacement__dt30.npz"))["xs"]
    disp = MulticopterDisplay(mp.model, mp.platform,
                              frame_names=list(fx["disp_frames"]), cog=True)
    for k, i in enumerate(fx["disp_idx"]):
        x = ref[i]
        p, R = disp._base_pose(x)
        np.testing.assert_array_equal(p, x[:3])
        np.testing.assert_allclose(R, fx["disp_R_rbd"][k], rtol=0, atol=TOL)
        rp, rd = disp._world_rotors(x)
        np.testing.assert_allclose(rp, fx["disp_rbd_rotor_p"][k], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(rd, fx["disp_rbd_rotor_d"][k], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(disp._cog_world(x), fx["disp_cog"][k],
                                   rtol=0, atol=TOL)
        for f, (fp, fR) in enumerate(disp._frame_poses(x)):
            np.testing.assert_allclose(fp, fx["disp_frame_p"][k, f], rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(fR, fx["disp_frame_R"][k, f], rtol=0,
                                       atol=TOL)
        rolled = torch.as_tensor(np.roll(x[3:7], -1))
        np.testing.assert_allclose(lie.quat_to_rot(rolled).numpy(),
                                   fx["disp_R_drawn"][k], rtol=0, atol=TOL)
    assert np.abs(fx["disp_R_drawn"] - fx["disp_R_rbd"]).max() > 0.1


def _line_data(fig):
    """Every line's data of every axes (3-D lines with their z)."""
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            data = (line.get_data_3d() if hasattr(line, "get_data_3d")
                    else line.get_data())
            out.append(np.asarray([np.asarray(d, dtype=float) for d in data]))
    return out


def test_figures_carry_jax_line_data():
    rng = np.random.default_rng(3)
    nq, nv, n_rot = 10, 9, 6
    xs = rng.normal(size=(25, nq + nv))
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=-1, keepdims=True)
    us = rng.uniform(0, 5, size=(24, n_rot + 3))
    costs = rng.uniform(0.1, 10, size=24)
    iters = rng.integers(1, 5, size=24)
    wps = rng.normal(size=(3, 3))
    calls = [
        lambda m: m.plot_states(xs, 0.02, nq),
        lambda m: m.plot_controls(us, 0.02, n_rot),
        lambda m: m.plot_controls(us[:, :n_rot], 0.02, n_rot),
        lambda m: m.plot_controls_group(us, 0.02, n_rot, group=4),
        lambda m: m.plot_trajectory_3d(xs, wps, elev=20, azim=30),
        lambda m: m.plot_solver_telemetry(costs, iters, 0.02),
        lambda m: m.plot_solver_telemetry(costs),
    ]
    for call in calls:
        got, want = _line_data(call(plots)), _line_data(call(jax_plots))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    plt.close("all")


def test_display_and_animate_headless(tmp_path):
    """``display`` (with thrust arrows, frames, payload, CoG) and ``animate``
    (saved as a GIF) on iris and the flagship."""
    for robot in ("iris", FLAGSHIP):
        mp = load_port(robot, "hover" if robot == "iris" else
                       "displacement")[1]
        disp = MulticopterDisplay(mp.model, mp.platform,
                                  frame_names=[mp.platform.base_link_name],
                                  payload=True, cog=True)
        n = 6
        xs = np.tile(np.concatenate([np.zeros(3), [0, 0, 0, 1],
                                     np.zeros(mp.model.nq - 7 + mp.model.nv)]),
                     (n, 1))
        xs[:, 2] = np.linspace(0.0, 1.0, n)
        us = np.full((n - 1, mp.platform.nu), 2.0)
        fig, ax = disp.display(xs, us, n_frames=3)
        assert len(ax.get_lines()) > 0
        anim = disp.animate(xs, us, stride=3)
        anim.save(str(tmp_path / f"{robot}.gif"), writer="pillow")
        assert (tmp_path / f"{robot}.gif").stat().st_size > 0
    plt.close("all")


def test_plot_flags_write_figures(tmp_path):
    """``--plot DIR`` on the closed loop (iris hover, 2 ticks) and on the
    offline solve (iris hover, dt 60) writes its figures."""
    d = tmp_path / "mpc"
    assert mpc_main.main(["iris", "hover", "--cpu", "--f64", "--dt", "100",
                          "--dt-sim", "20", "--horizon-factor", "0.04",
                          "--plot", str(d)]) == 0
    for name in ("cl_states", "cl_controls", "cl_telemetry"):
        assert (d / f"{name}.png").stat().st_size > 0
    d = tmp_path / "traj"
    traj_main.main(["iris", "hover", "--dt", "60", "--maxiter", "5", "--cpu",
                    "--f64", "--plot", str(d)])
    for name in ("states", "controls", "traj3d"):
        assert (d / f"{name}.png").stat().st_size > 0
    plt.close("all")
