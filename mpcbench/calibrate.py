"""Readings the limits of ``limits/<cell>.json`` are set from: the gaps of
the program on many seeds, of the control and of a planted fault on a few,
in one process.

    python3 mpcbench/calibrate.py --workload <cell> --seeds 11 12 ...
        --control-seeds 21 22 23 [--fault third --fault-seeds 31 32 33]
        --seconds <s> [--out readings.jsonl] [--write-limits]

For each seed the cell's window runs (``--seconds``) and its sampled ticks
are compared with the reference, as a benchmark run does (the program's
reading). For each control seed the same sampled inputs also go through the
control: the reference itself on the card in the configuration's float32
with TF32 matrix products allowed, the nearest precision below, in the
program's place. For each fault seed the window runs again with the fault
of ``faults.py`` planted in the program's step. Prints one JSON line per
seed and reading, with every row's gaps, and a summary: per number the
largest program reading and the smallest control and fault readings. The
benchmark's runs never run this.

``--write-limits`` then sets ``limits/<cell>.json`` from the readings: for
each quantile gap (``u0_p90``, ``x_p90``, ``xs_p90``, ``us_p90``,
``cost_p90``) whose smallest control reading is three times its largest
program reading or more, the limit lies two thirds of the way from the
lower to the upper reading on a log scale (more room above the program's
reading, which fresh seeds exceed, than below the control's); ``t`` is
exact (limit 0); a number that does not separate is left out.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

HELD = ("u0_p90", "x_p90", "xs_p90", "us_p90", "cost_p90")


def readings(c, seeds, control_seeds, seconds, device, emit, fault=None,
             fault_seeds=()):
    """{"program": [gaps...], "control": [...], "fault": [...]}."""
    from mpcbench import faults
    from mpcbench.harness import catalog, cell, program
    from mpcbench.harness import traffic as trf
    from mpcbench.harness import window as W
    from mpcbench.reference import compare
    from mpcbench.reference.tick import ReferenceTick, tf32_products

    config, traffic = c.config, c.traffic
    setup = program.controller(config, traffic, catalog.REPO, device)
    ref = ReferenceTick(config, traffic, catalog.REPO, device,
                        program.DTYPES[config["dtype"]])
    buf = step = None
    out = {"program": [], "control": [], "fault": []}
    K = traffic["chain_ticks"]
    for seed in dict.fromkeys(list(seeds) + list(control_seeds)
                              + list(fault_seeds)):
        starts = cell._starts(setup, traffic, seed)
        if step is None:
            buf, step = program.capture(setup, traffic,
                                        cell._first_buffers(starts))
            broken = faults.FAULTS[fault](step, buf) if fault else None
        runs = []
        if seed in seeds or seed in control_seeds:
            runs.append(("program", step))
        if seed in fault_seeds:
            runs.append(("fault", broken))
        for kind, s in runs:
            plan = trf.plan(traffic, seed, K)
            res = W.run(buf, s, starts, traffic, plan, seconds=seconds)
            chosen = plan.choose(sorted(res.snapshots))
            ins, outs = cell.stack(res.snapshots, chosen, plan.rows)
            args = (ins["t"], ins["x"], ins["xs"], ins["us"])
            want = ref(*args)
            got = []
            if kind == "fault" or seed in seeds:
                got.append((kind, outs))
            if kind == "program" and seed in control_seeds:
                with tf32_products():
                    got.append(("control", ref(*args)))
            for k, g in got:
                gaps = compare.gaps(g, want)
                out[k].append(gaps)
                emit({"kind": k, "seed": seed, "fault": fault if
                      k == "fault" else None, "ticks": len(chosen),
                      "starts": sum(t == 0 for _, t in chosen),
                      "rows": int(ins["x"].shape[0]),
                      "window_ticks": res.ticks, "gaps": gaps,
                      "row_gaps": {n: v.tolist() for n, v in
                                   compare.row_gaps(g, want).items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--write-limits", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from mpcbench.harness import catalog

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    c = catalog.cell(args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload))
        if sink:
            sink.write(line + "\n")
            sink.flush()
        rec = {k: v for k, v in rec.items() if k != "row_gaps"}
        print(json.dumps(dict(rec, workload=args.workload)), flush=True)

    try:
        r = readings(c, args.seeds, args.control_seeds, args.seconds,
                     torch.device("cuda", 0), emit, args.fault,
                     args.fault_seeds)
    finally:
        if sink:
            sink.close()
    names = sorted({k for g in r["program"] + r["control"] for k in g})
    summary = {n: {"program_max": max((g[n] for g in r["program"]),
                                      default=None),
                   "control_min": min((g[n] for g in r["control"]),
                                      default=None),
                   "fault_min": min((g[n] for g in r["fault"]),
                                    default=None)} for n in names}
    result = {"summary": summary, "workload": args.workload,
              "device": torch.cuda.get_device_name(0),
              "seconds": time.perf_counter() - T_START}
    if args.write_limits:
        result["limits"] = limits_from(summary)
        with open(os.path.join(catalog.BENCH_DIR, "limits",
                               f"{args.workload}.json"), "w") as f:
            json.dump(result["limits"], f, indent=1)
            f.write("\n")
    print(json.dumps(result), flush=True)
    return 0


def limits_from(summary):
    """The limits the readings give (module docstring)."""
    limits = {}
    for name in HELD:
        lo = summary[name]["program_max"]
        hi = summary[name]["control_min"]
        if lo is not None and hi is not None and 0 < lo and hi >= 3 * lo:
            limits[name] = float(lo ** (1 / 3) * hi ** (2 / 3))
    limits["t"] = 0.0
    return limits


if __name__ == "__main__":
    sys.exit(main())
