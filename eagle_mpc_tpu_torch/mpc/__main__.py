"""Closed-loop MPC demo: an offline SbFDDP solve, then a Carrot, Rail or
Weighted controller tracking it against the RK4 plant (the PyTorch twin of
the JAX package's examples/mpc.py).

    python3 -m eagle_mpc_tpu_torch.mpc [robot] [mission]
        [--controller carrot|rail|weighted] [--dt 20] [--dt-sim 2.0]
        [--horizon-factor 1.2] [--cpu] [--f64] [--smoke] [--plot DIR]

1. the offline solve: ``problem.from_trajectory`` (squashed controls,
   Euler, ``--dt`` ms nodes) and ``sbfddp.solve`` at maxiter 400;
2. the warm start: the offline solution's first T+1 states and T controls,
   its last state and control repeated where it is shorter;
3. ``run_closed_loop`` at B=1 from the offline solution's first state, one
   tick per ``--dt-sim`` ms over ``--horizon-factor`` of the mission's
   duration; it reports the ms per tick and the tracking error of the
   base position against the offline solution (mean and max).

Runs on the card unless ``--cpu`` is given; on the card the loop runs
twice and the second run is the steady one. ``--smoke`` runs iris hover on
the CPU at dt 60 ms, a 20 ms plant and 0.15 of the mission, and exits 1
unless the states stay finite and the mean tracking error is under 0.5 m.
``--plot DIR`` writes the closed loop's states, controls and per-tick
solver telemetry as ``cl_states.png``, ``cl_controls.png`` and
``cl_telemetry.png`` (``viz.plots``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import load_mpc_params, load_trajectory
from ..sim import AerialSimulator
from ..utils import log, tools
from . import (CarrotMpc, RailMpc, WeightedMpc, hold_padded, offline_solution,
               run_closed_loop)

MISSIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "missions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("robot", nargs="?", default="hexacopter370_flying_arm_3")
    ap.add_argument("mission", nargs="?", default="displacement")
    ap.add_argument("--controller", choices=["carrot", "rail", "weighted"],
                    default="carrot")
    ap.add_argument("--dt", type=int, default=20, help="trajectory dt [ms]")
    ap.add_argument("--dt-sim", type=float, default=2.0, help="plant dt [ms]")
    ap.add_argument("--horizon-factor", type=float, default=1.2,
                    help="simulate this fraction of the mission duration")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny closed loop on the CPU, check tracking")
    ap.add_argument("--plot", metavar="DIR", default=None,
                    help="write the closed loop's figures into DIR")
    args = ap.parse_args(argv)
    if args.smoke:
        args.robot, args.mission = "iris", "hover"
        args.dt, args.dt_sim, args.cpu = 60, 20.0, True
        args.horizon_factor = 0.15

    if not args.cpu and not torch.cuda.is_available():
        log.error("no CUDA device: pass --cpu to run on the CPU")
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    traj = load_trajectory(f"{args.robot}/trajectories/{args.mission}.yaml",
                           yaml_dir=MISSIONS)
    mp = load_mpc_params(f"{args.robot}/mpc/mpc.yaml", yaml_dir=MISSIONS)

    # 1. the offline reference solve
    xs_off, us_off, res = offline_solution(traj, args.dt, 400, device, dtype)
    log.info(f"offline solve: iters={int(res.iters[0])} "
             f"feasible={bool(res.feasible[0])}")

    kw = dict(mpc_params=mp, dt_ref=args.dt, device=device, dtype=dtype)
    if args.controller == "carrot":
        ctrl = CarrotMpc(trajectory=traj, state_ref=xs_off, **kw)
    elif args.controller == "rail":
        ctrl = RailMpc(state_ref=xs_off, **kw)
    else:
        ctrl = WeightedMpc(trajectory=traj, **kw)

    # 2. the hold-padded warm start
    xs_w, us_w = hold_padded(ctrl.spec.T, xs_off, us_off, device, dtype)
    to_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, args.dt_sim,
                                        device=device, dtype=dtype)
    n_steps = int(traj.duration / args.dt_sim * args.horizon_factor)

    # 3. the closed loop
    runs = 1 if args.cpu else 2
    for run in range(runs):
        t0 = time.perf_counter()
        out = run_closed_loop(ctrl, sim, to_dev(xs_off[:1]), xs_w, us_w,
                              n_steps=n_steps, dt_sim_ms=args.dt_sim)
        wall = time.perf_counter() - t0
        log.info(f"closed loop run {run + 1} of {runs} ({n_steps} ticks): "
                 f"{wall:.2f} s, {wall / n_steps * 1e3:.2f} ms/tick (sim dt "
                 f"{args.dt_sim} ms)")

    states = out.states[0].double().numpy()
    t_sim = np.arange(1, n_steps + 1) * args.dt_sim
    ref_idx = np.clip((t_sim // args.dt).astype(int), 0, len(xs_off) - 1)
    errs = tools.mission_errors(states[1:], xs_off[ref_idx], mp.model.nq)[0]
    log.info(f"tracking error: mean {errs.mean():.4f} m, max {errs.max():.4f} m")
    if args.smoke:
        if not np.all(np.isfinite(states)):
            log.error("smoke: diverged")
            return 1
        if errs.mean() >= 0.5:
            log.error(f"smoke: tracking error {errs.mean():.3f} m")
            return 1
        print("SMOKE OK")
    if args.plot:
        from ..viz import plots

        os.makedirs(args.plot, exist_ok=True)
        dt_s = args.dt_sim / 1000.0
        host = lambda a: a[0].double().numpy()
        plots.save_fig(plots.plot_states(states, dt_s, mp.model.nq),
                       os.path.join(args.plot, "cl_states.png"))
        plots.save_fig(plots.plot_controls(host(out.controls), dt_s,
                                           mp.platform.n_rotors),
                       os.path.join(args.plot, "cl_controls.png"))
        plots.save_fig(plots.plot_solver_telemetry(host(out.costs),
                                                   out.solve_iters[0].numpy(),
                                                   dt_s),
                       os.path.join(args.plot, "cl_telemetry.png"))
        log.info(f"figures written to {args.plot}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
