"""Single-robot serving latency: ONE robot re-solved every control tick
(the PyTorch twin of the JAX package's tools/serving_bench.py).

    python3 -m eagle_mpc_tpu_torch.serving_bench [--cpu] [--ticks 50]
        [--reps 5] [--while-solver] [--t0 3500]

The workload is the flagship's: hexacopter370_flying_arm_3 on the
displacement mission, a ``CarrotMpc`` on the offline reference
(``config.load_ref``; the synthetic glide, and t0 = 0, where no cached
solve exists), B=1, float32, from the reference's state at ``--t0`` ms
(x0 tiled, hover thrust), a 2 ms plant, ``SbFddpSettings(
convergence_init=1e-3)``, the fixed-depth route. One tick: set x0 from the
plant, ``update_problem(t)``, the warm-started solve, apply
``us_squash[0]``. Its budget is the MPC node's duration (30 ms).

The tick is captured once in a CUDA graph (``mpc.graph.serving_tick``,
the solve's sync-free route) that writes its results back into its
inputs. Printed on one line:

- ``capture``: seconds of the eager warm-up and the capture;
- ``device_tick``: ``--ticks`` (K) replays in a row with one fetch at the
  end, divided by K, median of ``--reps``: the loop lives on the device,
  as the JAX bench's ``lax.scan``;
- ``roundtrip_tick``: x0 copied into the graph's buffer, one replay, u0
  fetched, median of 5 * ``--reps``: sensors and actuators force a host
  hop every tick;
- ``eager_tick``: the same K ticks without the graph (the solve's default
  route, which tests on the host and exits early), as ``device_tick``, in
  the same run;
- the budget, whether each of the two ticks keeps it, and the last cost.

``--while-solver`` runs the while-loop solve instead, which cannot be
captured: every number is then an eager one, and the line says so. Runs
on the card unless ``--cpu`` is given (there the graph's callable runs
eagerly).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import load_mpc_params, load_ref, load_trajectory
from .mpc import CarrotMpc
from .mpc import graph as G
from .sim import AerialSimulator
from .solvers import fddp, sbfddp

MISSIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "missions")
FLAGSHIP = ("hexacopter370_flying_arm_3", "displacement", 30)
DT_PLANT = 2.0     # ms


class Workload(NamedTuple):
    ctrl: CarrotMpc
    sim: AerialSimulator
    settings: sbfddp.SbFddpSettings
    start: G.TickBuffers     # t0, x0, xs0, us0 (B, ...)
    budget_ms: int


def workload(robot=FLAGSHIP[0], mission=FLAGSHIP[1], dt_ref=FLAGSHIP[2],
             t0: float = 3500.0, device=None,
             dtype=torch.float32) -> Workload:
    """The bench's controller, plant, settings and start at B=1 (the
    flagship's by default)."""
    device = torch.device("cuda", 0) if device is None else device
    traj = load_trajectory(f"{robot}/trajectories/{mission}.yaml",
                           yaml_dir=MISSIONS)
    mp = load_mpc_params(f"{robot}/mpc/mpc.yaml", yaml_dir=MISSIONS)
    ref, kind = load_ref(robot, mission, dt_ref, traj=traj)
    if kind == "synthetic":
        t0 = 0.0   # the glide has no stage transition to cross
    ctrl = CarrotMpc(mpc_params=mp, trajectory=traj, state_ref=ref,
                     dt_ref=dt_ref, device=device, dtype=dtype)
    sim = AerialSimulator.from_platform(mp.model, mp.platform, DT_PLANT,
                                        device=device, dtype=dtype)
    settings = sbfddp.SbFddpSettings(convergence_init=1e-3,
                                     solver=fddp.SolverSettings())
    T, nu, nx = ctrl.spec.T, ctrl.spec.nu, ctrl.spec.model.nx
    i0 = min(int(t0 // dt_ref), ref.shape[0] - 1)
    x0 = torch.as_tensor(ref[i0][None], dtype=dtype, device=device)
    hover = float(mp.model.inertia[0][0, 0]) * 9.81 / mp.platform.n_rotors
    us0 = torch.zeros(1, T, nu, dtype=dtype, device=device)
    us0[..., :mp.platform.n_rotors] = hover
    start = G.make_buffers(t0, x0, x0[:, None].expand(1, T + 1, nx), us0)
    return Workload(ctrl, sim, settings, start, mp.dt)


def reset(buf: G.TickBuffers, start: G.TickBuffers) -> None:
    for a, b in zip(buf, start):
        a.copy_(b)


def device_ticks(replay, buf, start, K: int, reps: int, sync) -> tuple:
    """(median seconds per tick of K ticks in a row from ``start`` with one
    fetch at the end, the last tick's costs)."""
    ts, costs = [], None
    for _ in range(reps):
        reset(buf, start)
        sync()
        t0 = time.perf_counter()
        for _ in range(K):
            out = replay()
        costs = out.cost.cpu()
        ts.append((time.perf_counter() - t0) / K)
    return float(np.median(ts)), costs


def roundtrip_ticks(replay, buf, start, n: int) -> float:
    """Median seconds of one tick with x0 copied up and u0 fetched."""
    reset(buf, start)
    x_h = start.x.cpu()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        buf.x.copy_(x_h)
        out = replay()
        out.u0.cpu()
        ts.append(time.perf_counter() - t0)
        x_h = buf.x.cpu()
    return float(np.median(ts))


def run(w: Workload, K: int = 50, reps: int = 5, while_solver: bool = False,
        eager_reps: Optional[int] = None):
    """The bench: {capture_s, device_tick_ms, roundtrip_tick_ms,
    eager_tick_ms, final_cost, captured}; 5 * ``reps`` ticks give the round
    trip's median, ``eager_reps`` (default ``reps``) runs of K the eager
    tick's. ``while_solver``: every tick eager on the while-loop solve
    (``capture_s`` its first tick)."""
    dev = w.start.x.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    buf = w.start.clone()
    tick = lambda **route: G.serving_tick(w.ctrl, w.sim, w.settings, DT_PLANT,
                                          buf, **route)
    sync()
    t0 = time.perf_counter()
    if while_solver:
        replay, captured = tick(fixed=False, sync_free=False), False
        replay()
    else:
        step = G.CapturedStep(tick(), dev, state=buf)
        replay, captured = step.replay, step.graph is not None
    sync()
    capture_s = time.perf_counter() - t0
    device_s, costs = device_ticks(replay, buf, w.start, K, reps, sync)
    roundtrip_s = roundtrip_ticks(replay, buf, w.start, 5 * reps)
    eager = (replay if while_solver
             else tick(sync_free=False))     # the default route, eager
    eager_s, _ = device_ticks(eager, buf, w.start, K, eager_reps or reps,
                              sync)
    return {"capture_s": capture_s, "device_tick_ms": device_s * 1e3,
            "roundtrip_tick_ms": roundtrip_s * 1e3,
            "eager_tick_ms": eager_s * 1e3, "final_cost": float(costs[-1]),
            "captured": captured}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--while-solver", action="store_true",
                    help="the while-loop solve, eager (it cannot be captured)")
    ap.add_argument("--t0", type=float, default=3500.0,
                    help="mission time (ms) of the first tick: the default "
                         "crosses the second waypoint's stage transition")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    w = workload(t0=args.t0, device=device)
    r = run(w, args.ticks, args.reps, args.while_solver)
    route = ("while (eager, not captured)" if args.while_solver
             else "fixed sync-free (CUDA graph)" if r["captured"]
             else "fixed sync-free (eager on the CPU)")
    print(f"platform={device.type} route={route} "
          f"capture={r['capture_s']:.1f}s "
          f"device_tick={r['device_tick_ms']:.2f}ms "
          f"roundtrip_tick={r['roundtrip_tick_ms']:.2f}ms "
          f"eager_tick={r['eager_tick_ms']:.2f}ms "
          f"budget={w.budget_ms}ms "
          f"device_ok={r['device_tick_ms'] <= w.budget_ms} "
          f"roundtrip_ok={r['roundtrip_tick_ms'] <= w.budget_ms} "
          f"final_cost={r['final_cost']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
