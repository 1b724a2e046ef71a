"""The system under test: eagle_mpc_tpu_torch's served tick, built from a
configuration file and a traffic mix through the port's public API, and
captured in a CUDA graph.

Only these names of the port are used: ``config.load_trajectory``,
``load_mpc_params``, ``load_ref``; the controller class the configuration
names under ``mpc``; ``sim.AerialSimulator``; ``mpc.graph.make_buffers``,
``serving_tick``, ``CapturedStep``; ``solvers.sbfddp``.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Setup(NamedTuple):
    ctrl: object
    sim: object
    settings: object
    x_t0: np.ndarray       # (nx,) the offline reference's state at t0
    hover_us: torch.Tensor  # (T, nu) hover thrust on the rotors
    dtype: torch.dtype
    device: torch.device


def _yaml_value(server, key, like):
    """The mission YAML's value of ``key`` read as the type of ``like``."""
    if isinstance(like, bool):
        return server.get_bool(key)
    if isinstance(like, (int, float)):
        return server.get_double(key)
    if isinstance(like, list):
        return server.get_vector(key).tolist()
    return server.get_string(key)


def check_config(mp, config: Dict) -> None:
    """Raise unless the controller as loaded is the configuration file's:
    every key of ``mpc_controller`` equals the repository's copy of the
    source YAML (``missions/<mpc_yaml>``), but those listed in ``reduced``,
    which the file changes."""
    for key, want in config["mpc_controller"].items():
        if key in config["reduced"]:
            continue
        got = _yaml_value(mp.server, "mpc_controller/" + key, want)
        same = (np.allclose(got, want, rtol=0, atol=0)
                if isinstance(want, (int, float, list))
                and not isinstance(want, bool) else got == want)
        if not same:
            raise ValueError(f"configuration {config['name']}: "
                             f"mpc_controller/{key} is {got!r} in the YAML, "
                             f"{want!r} in the file, and not in 'reduced'")
    mc = config["mpc_controller"]
    for field in ("integration_method", "knots", "iters", "dt", "solver"):
        if getattr(mp, field) != mc[field]:
            raise ValueError(f"configuration {config['name']}: {field} runs as "
                             f"{getattr(mp, field)!r}, the file says "
                             f"{mc[field]!r}")


def controller(config: Dict, traffic: Dict, repo: str, device) -> Setup:
    """The configuration's controller, plant and solver settings on
    ``device`` in its dtype, and the traffic's start state."""
    from eagle_mpc_tpu_torch import config as pconfig
    from eagle_mpc_tpu_torch.sim import AerialSimulator
    from eagle_mpc_tpu_torch.solvers import sbfddp

    dtype = DTYPES[config["dtype"]]
    missions = os.path.join(repo, "missions")
    traj = pconfig.load_trajectory(config["trajectory_yaml"], yaml_dir=missions)
    mp = pconfig.load_mpc_params(config["mpc_yaml"], yaml_dir=missions)
    mp = dataclasses.replace(mp, **{k: config["mpc_controller"][k]
                                    for k in config["reduced"]
                                    if k in config["mpc_controller"]})
    check_config(mp, config)
    ref, kind = pconfig.load_ref(config["robot"], config["mission"],
                                 config["offline_ref_dt_ms"], traj=traj)
    if kind != "offline":
        raise FileNotFoundError(f"the cached offline solve of {config['robot']}"
                                f" {config['mission']} at "
                                f"{config['offline_ref_dt_ms']} ms is missing")
    c = config["controller"]
    cls = getattr(importlib.import_module(
        f"eagle_mpc_tpu_torch.mpc.{c['module']}"), c["class"])
    available = {"trajectory": traj, "state_ref": ref,
                 "dt_ref": config["offline_ref_dt_ms"]}
    ctrl = cls(mpc_params=mp, device=device, dtype=dtype,
               **{k: available[k] for k in c["args"]})
    sizes = config["sizes"]
    got = {"nx": ctrl.spec.model.nx, "ndx": ctrl.spec.state.ndx,
           "nu": ctrl.spec.nu, "knots": ctrl.knots, "T": ctrl.spec.T}
    if got != sizes:
        raise ValueError(f"configuration {config['name']}: sizes {got}, the "
                         f"file says {sizes}")
    sim = AerialSimulator.from_platform(mp.model, mp.platform,
                                        traffic["plant_dt_ms"], device=device,
                                        dtype=dtype)
    settings = sbfddp.SbFddpSettings(
        convergence_init=traffic["convergence_init"])
    hover = float(mp.model.inertia[0][0, 0]) * 9.81 / mp.platform.n_rotors
    hover_us = torch.zeros(ctrl.spec.T, ctrl.spec.nu, dtype=dtype,
                           device=device)
    hover_us[:, :mp.platform.n_rotors] = hover
    t0 = float(traffic["t0_ms"])
    x_t0 = ref[min(int(t0 // config["offline_ref_dt_ms"]), ref.shape[0] - 1)]
    return Setup(ctrl=ctrl, sim=sim, settings=settings,
                 x_t0=np.asarray(x_t0, np.float64), hover_us=hover_us,
                 dtype=dtype, device=torch.device(device))


def warm_start(ctrl, t_ms: float, x0, xs, us, depth: int):
    """The batch study's warm start: a depth-``depth`` fixed solve with the
    fixed polish and the default settings from (xs, us) at ``t_ms``."""
    from eagle_mpc_tpu_torch.ocp import problem as P
    from eagle_mpc_tpu_torch.solvers import sbfddp

    B = x0.shape[0]
    params = ctrl.update_problem(
        torch.full((B,), t_ms, device=x0.device, dtype=x0.dtype),
        P.expand_params(ctrl.params0, B)._replace(x0=x0))
    return sbfddp.solve_fixed(ctrl.spec, params, xs, us, depth=depth,
                              polish="fixed")


class EagerStep:
    """The tick called eagerly at every replay (the ``eager`` route)."""

    graph = None
    launches: Dict = {}

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        return self.fn()


def capture(setup: Setup, traffic: Dict, start):
    """Static buffers filled from ``start`` (a ``TickBuffers`` at the
    traffic's t0) and the served tick over them: (buffers, step). On the
    ``graph`` route the tick is captured in a CUDA graph (on a CPU device
    the step calls it eagerly) and a failed capture raises; on the
    ``eager`` route it runs the solve's fixed route
    (``MpcAbstract.solve(fixed=True)``, which reads the host between
    iterations) at every replay."""
    from eagle_mpc_tpu_torch.mpc import graph as G

    buf = G.make_buffers(float(traffic["t0_ms"]), start.x, start.xs, start.us)
    route = traffic["route"]
    if route not in ("graph", "eager"):
        raise ValueError(f"route must be graph or eager, got {route!r}")
    tick = G.serving_tick(setup.ctrl, setup.sim, setup.settings,
                          traffic["plant_dt_ms"], buf,
                          sync_free=route == "graph")
    if route == "eager":
        return buf, EagerStep(tick)
    return buf, G.CapturedStep(tick, setup.device, state=buf)
