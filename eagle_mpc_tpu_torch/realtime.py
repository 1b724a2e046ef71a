"""Real-time closed-loop MPC serving: the MPC tick, captured in CUDA
graphs, dispatched by the native periodic executor (the PyTorch twin of
the JAX package's examples/mpc_realtime.py).

    python3 -m eagle_mpc_tpu_torch.realtime [robot] [mission] [--dt 40]
        [--period 20] [--ticks 100] [--cpu] [--f64] [--smoke]

1. the offline solve: ``problem.from_trajectory`` (squashed controls,
   Euler, ``--dt`` ms nodes) and ``sbfddp.solve`` at maxiter 200;
2. a ``CarrotMpc`` on that solution, the warm start its first T+1 states
   and T controls (its last ones repeated where it is shorter), the plant
   stepping ``--period`` ms, at B=1;
3. the tick as two CUDA graphs (``mpc.graph.capture_split``): the update,
   then the sync-free fixed-depth solve with the plant step, which writes
   the next state, the candidates and the time back into the graphs'
   buffers; captured after an eager warm-up, outside the timed loop;
4. ``--ticks`` ticks inside ``utils.rt_executor.RealTimeExecutor`` at
   ``--period`` ms, each recording the update's and the solve's seconds
   (each closed by a device synchronize), its cost and iterations.

It logs the executor's statistics, whether the loop kept real time (mean
update + solve within the period) and the plant's distance to the
trajectory's end. Runs on the card unless ``--cpu`` is given (there the
graphs' callables run eagerly). ``--smoke``: iris hover at dt 60 ms, a
50 ms period, 5 ticks on the CPU; exits 1 unless the plant stays finite
and the executor counted every tick, then prints ``SMOKE OK``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .config import load_mpc_params, load_trajectory
from .mpc import CarrotMpc, hold_padded, offline_solution
from .mpc import graph as G
from .sim import AerialSimulator
from .utils import log
from .utils.rt_executor import RealTimeExecutor

MISSIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "missions")


def serve(robot: str, mission: str, dt_ms: int, period_ms: float, ticks: int,
          device, dtype):
    """Steps 1 to 4 of the module docstring: (the executor's statistics,
    the plant's last state (nx,) float64, the offline solution's states)."""
    cuda = device.type == "cuda"
    traj = load_trajectory(f"{robot}/trajectories/{mission}.yaml",
                           yaml_dir=MISSIONS)
    mp = load_mpc_params(f"{robot}/mpc/mpc.yaml", yaml_dir=MISSIONS)
    xs_off, us_off, res = offline_solution(traj, dt_ms, 200, device, dtype)
    log.info(f"offline solve: iters={int(res.iters[0])} "
             f"feasible={bool(res.feasible[0])}")
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=xs_off,
                     dt_ref=dt_ms, device=device, dtype=dtype)
    xs_w, us_w = hold_padded(ctrl.spec.T, xs_off, us_off, device, dtype)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, period_ms,
                                        device=device, dtype=dtype)
    x0 = torch.as_tensor(xs_off[:1], dtype=dtype, device=device)
    buf = G.make_buffers(0.0, x0, xs_w, us_w)
    update, solve = G.capture_split(ctrl, sim, ctrl.solver_settings(),
                                    period_ms, buf)
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    log.info(f"serving {ticks} ticks @ {period_ms:.0f} ms on {device}"
             f"{' (CUDA graphs)' if cuda else ' (eager)'}")
    with RealTimeExecutor(period_s=period_ms / 1000.0) as ex:
        for _ in range(ticks):
            ex.wait_next()
            t0 = ex.now()
            update.replay()
            sync()
            t1 = ex.now()
            out = solve.replay()
            sync()
            t2 = ex.now()
            ex.record(t1 - t0, t2 - t1, float(out.cost[0]),
                      int(out.iters[0]))
        stats = ex.stats()
    return stats, buf.x[0].detach().to("cpu", torch.float64).numpy(), xs_off


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("robot", nargs="?", default="iris")
    ap.add_argument("mission", nargs="?", default="hover")
    ap.add_argument("--dt", type=int, default=40, help="trajectory dt [ms]")
    ap.add_argument("--period", type=float, default=20.0,
                    help="control period [ms]")
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="few ticks on the CPU, check the serving loop")
    args = ap.parse_args(argv)
    if args.smoke:
        args.robot, args.mission = "iris", "hover"
        args.dt, args.period, args.ticks, args.cpu = 60, 50.0, 5, True

    if not args.cpu and not torch.cuda.is_available():
        log.error("no CUDA device: pass --cpu to run on the CPU")
        return 2
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    dtype = torch.float64 if args.f64 else torch.float32
    stats, x, xs_off = serve(args.robot, args.mission, args.dt, args.period,
                             args.ticks, device, dtype)
    log.info(str(stats))
    rt_ok = stats.total_avg <= args.period / 1000.0
    log.info(f"real-time at {args.period:.0f} ms period: "
             f"{'YES' if rt_ok else 'NO'} "
             f"(avg tick {stats.total_avg * 1e3:.2f} ms)")
    err = np.linalg.norm(x[:3] - xs_off[-1][:3])
    log.info(f"plant vs trajectory end after {args.ticks} ticks: {err:.3f} m")
    if args.smoke:
        if not np.all(np.isfinite(x)):
            log.error("smoke: plant diverged")
            return 1
        if stats.n != args.ticks:
            log.error(f"smoke: the executor counted {stats.n} ticks")
            return 1
        print("SMOKE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
