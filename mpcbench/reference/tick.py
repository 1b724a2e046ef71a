"""The served tick in plain PyTorch: the reference that decides ``correct``.

One tick, as the port's ``mpc.graph.serving_tick`` defines it: the
controller's ``update_problem`` at the mission time ``t`` from the plant
states ``x``, the fixed-depth SbFDDP solve warm-started from ``xs``/``us``
(here on its eager route, which the sync-free route equals element for
element), the plant stepped with the first squashed control, and the time
advanced by the plant's period. Every row of a batch is its own problem, so
rows drawn from different ticks can be solved together.

Everything is built from the benchmark's configuration file and the
repository's raw mission files, with this package's own modules.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Dict

import numpy as np
import torch

from . import config as rconfig
from .ocp import problem as P
from .sim import AerialSimulator
from .solvers import fddp, sbfddp

_PKG = __name__.rsplit(".", 1)[0]


class ReferenceTick:
    """The configuration's controller and plant in ``dtype`` on ``device``.

    ``config``: the benchmark's configuration (its JSON as a dict);
    ``traffic``: the mix (plant period, solver settings); ``repo``: the
    checkout's root, which holds ``missions/`` and ``robots/``."""

    def __init__(self, config: Dict, traffic: Dict, repo: str, device,
                 dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        missions = os.path.join(repo, "missions")
        traj = rconfig.load_trajectory(config["trajectory_yaml"],
                                       yaml_dir=missions)
        mp = rconfig.load_mpc_params(config["mpc_yaml"], yaml_dir=missions)
        changed = {k: config["mpc_controller"][k] for k in config["reduced"]
                   if k in config["mpc_controller"]}
        mp = dataclasses.replace(mp, **changed)
        ref, _ = rconfig.load_ref(config["robot"], config["mission"],
                                  config["offline_ref_dt_ms"], traj=traj)
        self.state_ref, self.dt_ref = ref, config["offline_ref_dt_ms"]
        available = {"trajectory": traj, "state_ref": ref,
                     "dt_ref": config["offline_ref_dt_ms"]}
        c = config["controller"]
        cls = getattr(importlib.import_module(f"{_PKG}.mpc.{c['module']}"),
                      c["class"])
        self.ctrl = cls(mpc_params=mp, device=self.device, dtype=dtype,
                        **{k: available[k] for k in c["args"]})
        self.sim = AerialSimulator.from_platform(
            mp.model, mp.platform, traffic["plant_dt_ms"], device=self.device,
            dtype=dtype)
        self.settings = sbfddp.SbFddpSettings(
            convergence_init=traffic["convergence_init"])
        self.period_ms = float(traffic["plant_dt_ms"])

    def __call__(self, t, x, xs, us) -> Dict[str, np.ndarray]:
        """The tick over rows: ``t`` (R,), ``x`` (R, nx), ``xs``
        (R, T+1, nx), ``us`` (R, T, nu), any float arrays. Returns the
        tick's outputs as float64 numpy arrays: ``t``, ``x``, ``xs``, ``us``
        (the buffers after the tick), ``u0``, ``cost``, ``feasible``,
        ``iters``."""
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                         device=self.device)
        t, x, xs, us = map(as_t, (t, x, xs, us))
        params0 = P.expand_params(self.ctrl.params0, x.shape[0])
        params = self.ctrl.update_problem(t, params0._replace(x0=x))
        r = self.ctrl.solve(params, xs, us, settings=self.settings,
                            fixed=True)
        u0 = r.us_squash[:, 0]
        x_next = self.sim.step(x, u0)
        out = {"t": t + self.period_ms, "x": x_next, "xs": r.xs, "us": r.us,
               "u0": u0, "cost": r.cost, "feasible": r.feasible,
               "iters": r.iters}
        return {k: v.detach().to("cpu", torch.float64).numpy()
                for k, v in out.items()}


class tf32_products:
    """A block in which the reference's float32 matrix products on the card
    may run in TF32 (the control): the solver's entry, which turns TF32
    off, is replaced for the block."""

    def __enter__(self):
        self._entry = fddp.full_precision_matmul
        self._flags = (torch.backends.cuda.matmul.allow_tf32,
                       torch.get_float32_matmul_precision())

        def allow():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
        fddp.full_precision_matmul = allow
        allow()
        return self

    def __exit__(self, *exc):
        fddp.full_precision_matmul = self._entry
        torch.backends.cuda.matmul.allow_tf32 = self._flags[0]
        torch.set_float32_matmul_precision(self._flags[1])
        return False
