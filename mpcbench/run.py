"""Run one cell of BENCHMARK.json on one NVIDIA card and print its result.

    python3 mpcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
with the reference beside its limit; the same numbers are the last lines of
standard error. Exits 2 without a result where there is no CUDA device or
fewer than the cell asks for, and 3 where a module of JAX or of the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from mpcbench.harness import catalog, cell, guard

    c = catalog.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {c.chips} CUDA device(s); "
              f"{n} available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    line = cell.run(c, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_START)
    bad = guard.forbidden()
    if bad:
        print(f"loaded modules of {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    d = line["device"]
    print(f"device: {d['kind']}, {d['count']} card(s), power limit "
          f"{d.get('power_limit_w')} W", file=sys.stderr)
    for name, ch in line["checks"].items():
        print(f"check {name}: {ch['value']!r} (limit {ch['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
