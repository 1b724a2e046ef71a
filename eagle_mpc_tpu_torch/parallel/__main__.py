"""Batched scenario solving: many perturbed-x0 SbFDDP solves at once, on
the card through kernels K1, K2 and K3 (twin of
``examples/batch_scenarios.py``).

    python3 -m eagle_mpc_tpu_torch.parallel [robot] [mission] [--batch 1024]
        [--dt 40] [--maxiter 60] [--noise 0.05] [--cpu] [--backend B]
        [--smoke]

Runs on the card unless ``--cpu`` is given; float32, as the example. On
the card the solve runs twice and the second, steady one is reported (the
first includes the kernels' build and torch's lazy loading). Under
``EAGLE_MPC_COORDINATOR`` / ``EAGLE_MPC_NUM_PROCS`` / ``EAGLE_MPC_PROC_ID``
the process joins a multi-process world (``parallel.distributed``), solves
its rows of the batch and reduces the summary across the world;
``--backend gloo`` lets several ranks share one card (NCCL refuses that).
``--smoke``: iris hover on the CPU, B=8, dt 60 ms, maxiter 40; it asserts
that at least 99 % of the batch ends feasible and prints ``SMOKE OK``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..config import load_trajectory
from ..ocp import problem as P
from ..utils import log
from . import distributed as D
from .batch import convergence_summary, make_batch_solver, perturbed_x0_batch
from .mesh import shard_batch, sharded_summary

MISSIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "missions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("robot", nargs="?", default="iris")
    ap.add_argument("mission", nargs="?", default="hover")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--dt", type=int, default=40)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl on the "
                         "card, gloo on the CPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: tiny batch on the CPU, assert convergence")
    args = ap.parse_args(argv)
    if args.smoke:
        args.robot, args.mission = "iris", "hover"
        args.batch, args.dt, args.maxiter, args.cpu = 8, 60, 40, True
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to solve on the CPU", file=sys.stderr)
        return 2

    cpu = torch.device("cpu")
    mesh = None
    if "EAGLE_MPC_COORDINATOR" in os.environ:
        mesh = D.initialize(backend=args.backend,
                            device=cpu if args.cpu else None)
        device = mesh.device
    else:
        device = cpu if args.cpu else torch.device("cuda")
    traj = load_trajectory(f"{args.robot}/trajectories/{args.mission}.yaml",
                           yaml_dir=MISSIONS)
    spec, params = P.from_trajectory(traj, dt_ms=args.dt, use_squash=True,
                                     integrator="IntegratedActionModelEuler",
                                     dtype=torch.float32, device=device)
    world = 1 if mesh is None else mesh.world_size
    log.info(f"{args.batch} scenarios on {world} process(es) ({device}"
             + ("" if mesh is None else f", rank {mesh.rank}") + ")")

    bp = perturbed_x0_batch(params, args.batch, scale=args.noise)
    if mesh is not None:
        bp = shard_batch(mesh, bp, batch_size=args.batch)
        summarize = lambda r: sharded_summary(mesh, r)
    else:
        summarize = convergence_summary
    solve = make_batch_solver(spec, maxiter=args.maxiter, mesh=mesh)

    runs = 1 if device.type == "cpu" else 2
    for run in range(runs):
        t0 = time.perf_counter()
        res = solve(bp)
        s = summarize(res)   # across processes: a completion barrier
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if run + 1 < runs:
            log.info(f"first solve (kernel build, lazy loading): {wall:.1f}s")
    log.info(f"steady: {wall:.2f}s -> {args.batch / wall:.0f} solves/s | {s}")
    D.shutdown()
    if args.smoke:
        if s["feasible_frac"] < 0.99:
            raise SystemExit(f"smoke: {s}")
        print("SMOKE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
