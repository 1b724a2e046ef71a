"""Multi-process weak-scaling run: solves/s at 1, 2, ... ranks (the port's
counterpart of the reference package's ``tools/scaling_bench.py``).

    python3 -m eagle_mpc_tpu_torch.parallel.scaling [--hosts 1 2]
        [--per-host 32] [--reps 5] [--solver fixed|while] [--cpu]
        [--backend nccl|gloo] [--dtype float64|float32]

Spawns N ranks of ``parallel.worker`` (a ``torch.distributed`` world over
a ``tcp://127.0.0.1`` rendezvous), each solving its rows of a global batch
that grows with N (weak scaling: the work per rank is constant), and
reports the global solves/s per rank count and the efficiency against one
rank. Ranks go to the host's cards round-robin; with fewer cards than
ranks (or on the CPU, ``--cpu``) they share one, and the run exercises the
mechanism without scaling it: the output says so. Ranks that share a card
need ``--backend gloo`` (NCCL refuses them).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import torch

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_job(n_procs: int, global_batch: int, reps: int = 0,
            solver: str = "while", device: str = "cuda",
            backend=None, dtype: str = "float64", timeout: float = 600,
            pin_cores: bool = False):
    """Run ``n_procs`` ranks of ``parallel.worker`` to the end and return
    their ``WORKER_RESULT`` dicts, rank order. Every rank is killed if one
    fails or the timeout passes."""
    port = _free_port()
    procs = []
    try:
        for pid in range(n_procs):
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [PACKAGE_PARENT] + [p for p in [env.get("PYTHONPATH")] if p])
            env.update({
                "EAGLE_MPC_COORDINATOR": f"127.0.0.1:{port}",
                "EAGLE_MPC_NUM_PROCS": str(n_procs),
                "EAGLE_MPC_PROC_ID": str(pid),
                "EAGLE_MPC_GLOBAL_BATCH": str(global_batch),
                "EAGLE_MPC_TIME_REPS": str(reps),
                "EAGLE_MPC_SOLVER": solver,
                "EAGLE_MPC_DEVICE": device,
                "EAGLE_MPC_DTYPE": dtype,
            })
            if backend:
                env["EAGLE_MPC_BACKEND"] = backend
            if pin_cores:
                env["EAGLE_MPC_CPU_AFFINITY"] = str(pid % (os.cpu_count() or 1))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "eagle_mpc_tpu_torch.parallel.worker"],
                cwd=PACKAGE_PARENT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        results = []
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank {pid} of {n_procs} failed "
                                   f"({p.returncode}):\n{err[-3000:]}")
            line = [ln for ln in out.splitlines()
                    if ln.startswith("WORKER_RESULT ")]
            if not line:
                raise RuntimeError(f"rank {pid}: no WORKER_RESULT line:\n"
                                   f"{out[-2000:]}\n{err[-2000:]}")
            results.append(json.loads(line[-1][len("WORKER_RESULT "):]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def sharing_note(n_procs: int, device: str) -> str:
    """What the rank count means on this host."""
    if device == "cpu":
        return f"{n_procs} rank(s) share this host's CPU: mechanism, not scaling"
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_procs > n_dev:
        name = torch.cuda.get_device_name(0) if n_dev else "no card"
        return (f"{n_procs} rank(s) on {n_dev} card(s) ({name}): ranks share "
                "a card; mechanism, not scaling")
    return f"{n_procs} rank(s) on {n_procs} of {n_dev} card(s)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--per-host", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--solver", choices=["fixed", "while"], default="fixed",
                    help="fixed: deterministic per-element work (weak "
                         "scaling measures coordination, not lockstep "
                         "imbalance); while: the while-loop solver")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default=None,
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--dtype", choices=["float64", "float32"],
                    default="float64")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run the ranks on the CPU",
              file=sys.stderr)
        return 2

    rows = []
    for n in args.hosts:
        res = run_job(n, args.per_host * n, args.reps, args.solver, device,
                      args.backend, args.dtype, pin_cores=args.cpu)
        sps = res[0]["solves_per_s"]
        rows.append((n, args.per_host * n, sps))
        print(f"hosts={n:2d} global_batch={args.per_host * n:4d} "
              f"solves/s={sps:9.1f} ({sharing_note(n, device)})", flush=True)

    base = rows[0][2] / rows[0][0]
    print("\nhosts  batch  solves/s  efficiency")
    effs = {}
    for n, b, sps in rows:
        eff = sps / (base * n)
        effs[n] = round(eff, 3)
        print(f"{n:5d} {b:6d} {sps:9.1f} {eff:10.1%}")
    print(json.dumps({"metric": "weak_scaling_efficiency",
                      "per_host_batch": args.per_host,
                      "device": device, "dtype": args.dtype,
                      "solves_per_s": {n: round(s, 1) for n, _, s in rows},
                      "efficiency": effs,
                      "note": sharing_note(max(args.hosts), device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
