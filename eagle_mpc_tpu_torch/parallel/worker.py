"""One rank of a multi-process batch solve (the port's counterpart of the
reference package's ``tests/distributed_worker.py``).

    EAGLE_MPC_COORDINATOR=127.0.0.1:PORT EAGLE_MPC_NUM_PROCS=2 \\
    EAGLE_MPC_PROC_ID=0 python3 -m eagle_mpc_tpu_torch.parallel.worker

Each rank joins the world (``distributed.initialize``), materializes only
its rows of a seeded global batch of iris hover starts (dt 200 ms, x0 +
seed-0 noise of sd 0.03 off the quaternion), solves them with the
while-loop SbFDDP (maxiter 40) or the fixed-depth one (depth 40, the
``fixed`` polish), reduces the summary with ``all_reduce`` and prints one
``WORKER_RESULT {json}`` line: topology, summary, this process's launches
of kernels K1, K2 and K3 and its evaluations of the plain node dynamics
on the card (``problem.PLAIN_ON_CARD``; a solve on the card makes none)
and, when asked, the median time of a solve plus its summary (the
summary's collective is a completion barrier) and the global solves/s. A timed run first warms the
process up with a one-iteration solve (the first solve of a process
loads torch's and the port's kernels); the summary is then the last
timed solve's.

Environment (besides the three above):

- ``EAGLE_MPC_GLOBAL_BATCH`` (8), ``EAGLE_MPC_SOLVER`` (``while`` or
  ``fixed``), ``EAGLE_MPC_TIME_REPS`` (0: no timing);
- ``EAGLE_MPC_DEVICE``: ``cuda`` (default; rank r on card r mod the
  host's card count, so ranks share a card when there are fewer cards)
  or ``cpu``;
- ``EAGLE_MPC_BACKEND``: default ``nccl`` on a card, ``gloo`` on the CPU;
  ranks that share a card need ``gloo`` (NCCL refuses them);
- ``EAGLE_MPC_DTYPE``: ``float64`` (default, as the reference's worker)
  or ``float32``;
- ``EAGLE_MPC_CPU_AFFINITY``: a comma-separated core set for this rank
  (on the CPU, torch then takes that many threads; one otherwise).

The rank fails if the port imported jax, the reference package or
``tools``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..config import load_trajectory
from ..ocp import problem as P
from ..ops import node_cuda, riccati_cuda, rollout_cuda
from ..solvers import fddp, sbfddp
from . import distributed as D
from .batch import make_batch_solver, perturbed_x0s
from .mesh import make_sharded_summary

MISSIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "missions")
DT_MS = 200
MAXITER = 40
NOISE = 0.03


def foreign_modules():
    """Modules of jax, the reference package or ``tools`` in this process."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "eagle_mpc_tpu", "tools")
                  or m.startswith(("jax.", "eagle_mpc_tpu.", "tools.")))


def main() -> int:
    device = torch.device(os.environ.get("EAGLE_MPC_DEVICE", "cuda"))
    dtype = getattr(torch, os.environ.get("EAGLE_MPC_DTYPE", "float64"))
    affinity = os.environ.get("EAGLE_MPC_CPU_AFFINITY")
    if affinity and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {int(c) for c in affinity.split(",")})
    if device.type == "cpu":
        torch.set_num_threads(len(affinity.split(",")) if affinity else 1)
    mesh = D.initialize(backend=os.environ.get("EAGLE_MPC_BACKEND"),
                        device=None if device.type == "cuda" else device)
    topo = D.process_summary(mesh)

    traj = load_trajectory("iris/trajectories/hover.yaml", yaml_dir=MISSIONS)
    spec, params = P.from_trajectory(traj, dt_ms=DT_MS, use_squash=True,
                                     integrator="IntegratedActionModelEuler",
                                     dtype=dtype, device=mesh.device)
    B = int(os.environ.get("EAGLE_MPC_GLOBAL_BATCH", "8"))
    # the seeded global batch, each rank materializing only its rows
    x0_g = perturbed_x0s(params.x0.to("cpu", torch.float64), B, NOISE, 0)
    x0s = D.host_local_batch(B, lambda idx: x0_g[idx].numpy(), mesh=mesh)
    pb = P.expand_params(params, x0s.shape[0])._replace(x0=x0s.to(dtype))

    if os.environ.get("EAGLE_MPC_SOLVER", "while") == "fixed":
        # deterministic per-element work: weak scaling then measures the
        # coordination, not the lockstep imbalance of the while loop
        def solve_batch(iters=MAXITER):
            xs0, us0 = fddp.default_init(spec, pb)
            return sbfddp.solve_fixed(spec, pb, xs0, us0, depth=iters,
                                      polish="fixed")
    else:
        def solve_batch(iters=MAXITER):
            return make_batch_solver(spec, maxiter=iters, mesh=mesh)(pb)

    summarize = make_sharded_summary(mesh)
    reps = int(os.environ.get("EAGLE_MPC_TIME_REPS", "0"))
    times = []
    if reps:   # the warm-up: one iteration a stage
        res = solve_batch(1)
        summarize(res.feasible, res.failed, res.iters, res.cost)
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        res = solve_batch()
        summary = summarize(res.feasible, res.failed, res.iters, res.cost)
        times.append(time.perf_counter() - t0)
    out = {"topo": topo, "summary": summary, "dtype": str(dtype),
           "local_rows": int(x0s.shape[0]),
           "launches": {"node_linearization": node_cuda.LAUNCHES,
                        "riccati_backward": riccati_cuda.LAUNCHES,
                        "alpha_rollout": rollout_cuda.LAUNCHES},
           "plain_on_card": P.PLAIN_ON_CARD}
    if reps:
        out["median_s"] = float(np.median(times))
        out["solves_per_s"] = B / out["median_s"]
    bad = foreign_modules()
    if bad:
        raise RuntimeError(f"the port imported {bad}")
    D.shutdown()
    print("WORKER_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
