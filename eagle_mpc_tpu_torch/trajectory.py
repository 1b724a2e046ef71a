"""Offline trajectory generation: a mission YAML solved by SbFDDP.

    python3 -m eagle_mpc_tpu_torch.trajectory [robot] [mission] [--dt 30]
        [--maxiter 400] [--f64] [--verbose] [--cpu]
        [--batch B --noise 0.05 --seed S] [--out PATH.npz] [--plot DIR]
        [--integrator IntegratedActionModelEuler|IntegratedActionModelRK4]

Loads ``missions/<robot>/trajectories/<mission>.yaml``, builds the problem
(``problem.from_trajectory``, squashed controls, Euler unless
``--integrator`` names RK4; a mission with contacts gets the
contact-constrained dynamics) and solves it with
``sbfddp.solve`` (homotopy stages of the while-loop FDDP, then the DDP
polish), on the card unless ``--cpu`` is given. On the card the solve
runs twice and the second time is the steady one: the first includes the
kernels' build and torch's lazy loading of its own kernels. A contact
mission also prints the contact invariant of each element: the largest
|J a + a0| over the active contact rows of its nodes, evaluated on the
host in float64 after the solve.

- ``--verbose`` prints the per-iteration trace of element 0;
- ``--batch B`` solves B copies at once, x0 perturbed by seeded normal
  noise (sd ``--noise``, quaternion block untouched; element 0 too;
  ``parallel.batch.perturbed_x0_batch``);
- ``--out`` writes ``xs``, ``us``, ``us_squash``, ``dt_ms``, ``cost`` and
  ``iters`` (element 0 at B = 1, the batch otherwise);
- ``--plot DIR`` writes element 0's states, squashed controls and 3-D path
  as ``states.png``, ``controls.png`` and ``traj3d.png`` (``viz.plots``).

Exits 0 when every element ends feasible.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .config import load_trajectory
from .ocp import problem as P
from .parallel.batch import perturbed_x0_batch
from .solvers import fddp, sbfddp

MISSIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "missions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("robot", nargs="?", default="hexacopter370_flying_arm_3")
    ap.add_argument("mission", nargs="?", default="displacement")
    ap.add_argument("--dt", type=int, default=30, help="node duration, ms")
    ap.add_argument("--maxiter", type=int, default=400)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-iteration solver trace")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the solution (npz)")
    ap.add_argument("--plot", metavar="DIR", default=None,
                    help="write the solution's figures into DIR")
    ap.add_argument("--integrator", default="IntegratedActionModelEuler",
                    choices=("IntegratedActionModelEuler",
                             "IntegratedActionModelRK4"))
    args = ap.parse_args(argv)

    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to solve on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    traj = load_trajectory(f"{args.robot}/trajectories/{args.mission}.yaml",
                           yaml_dir=MISSIONS)
    spec, params = P.from_trajectory(traj, dt_ms=args.dt, use_squash=True,
                                     integrator=args.integrator,
                                     dtype=dtype, device=device)
    pb = (perturbed_x0_batch(params, args.batch, args.noise, args.seed)
          if args.batch > 1 else P.expand_params(params, 1))
    print(f"{args.robot}/{args.mission}: T={spec.T} nodes, dt={args.dt} ms, "
          f"nx={spec.model.nx}, nu={spec.nu}, {len(spec.slots)} cost slots, "
          f"{len(spec.contacts)} contacts, B={args.batch}, {dtype}, {device}",
          flush=True)

    settings = sbfddp.SbFddpSettings(
        solver=fddp.SolverSettings(record_trace=args.verbose))
    runs = 1 if args.cpu else 2
    for run in range(runs):
        t0 = time.perf_counter()
        res = sbfddp.solve(spec, pb, maxiter=args.maxiter, settings=settings)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        it = int(res.iters.max())
        print(f"solve {run + 1} of {runs}: {ms:.1f} ms, iters max {it} "
              f"({ms / max(it, 1):.2f} ms per iteration of the slowest "
              f"element)", flush=True)
    hold = None
    if spec.contacts:   # a check on host copies, in float64
        host64 = lambda a: a.detach().to("cpu", torch.float64)
        solved = sbfddp._set_homotopy(spec, P.map_params(host64, pb),
                                      float(res.smooth.max()))
        hold = P.contact_violation(spec, solved, host64(res.xs),
                                   host64(res.us)).amax(dim=1)
    for b in range(args.batch):
        print(f"element {b}: iters {int(res.iters[b])} cost "
              f"{float(res.cost[b]):.10g} feasible {bool(res.feasible[b])} "
              f"failed {bool(res.failed[b])} final position "
              f"{res.xs[b, -1, :3].tolist()}"
              + ("" if hold is None else
                 f" contact max |J a + a0| {float(hold[b]):.3e}"))
    if args.verbose:
        print(fddp.format_trace(fddp.IterTrace(*(a[0] for a in res.trace))))
    if args.out:
        pick = (lambda a: a[0]) if args.batch == 1 else (lambda a: a)
        host = lambda a: pick(a).detach().cpu().numpy()
        np.savez(args.out, xs=host(res.xs), us=host(res.us),
                 us_squash=host(res.us_squash), dt_ms=args.dt,
                 cost=host(res.cost), iters=host(res.iters))
        print(f"wrote {args.out}")
    if args.plot:
        from .viz import plots

        os.makedirs(args.plot, exist_ok=True)
        dt_s = args.dt / 1000.0
        host = lambda a: a[0].detach().to("cpu", torch.float64).numpy()
        xs = host(res.xs)
        plots.save_fig(plots.plot_states(xs, dt_s, spec.model.nq),
                       os.path.join(args.plot, "states.png"))
        plots.save_fig(plots.plot_controls(host(res.us_squash), dt_s,
                                           traj.platform.n_rotors),
                       os.path.join(args.plot, "controls.png"))
        plots.save_fig(plots.plot_trajectory_3d(xs),
                       os.path.join(args.plot, "traj3d.png"))
        print(f"figures written to {args.plot}/")
    return 0 if bool(res.feasible.all()) else 1


if __name__ == "__main__":
    sys.exit(main())
