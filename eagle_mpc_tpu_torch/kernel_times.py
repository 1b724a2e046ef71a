"""Time the three kernels of one or more checkouts of this repository on one
card, in turns, on the same inputs.

    python3 -m eagle_mpc_tpu_torch.kernel_times ROOT [ROOT ...]

Each ROOT is the root of a checkout (an unpacked ``git archive`` of
another commit, or ``.``); each runs in a process of its own, in the order
given (e.g. ``parent . . parent``), and uses that checkout's own
``chip_smoke.py`` helpers and kernels. The inputs are the JAX fixtures'
float32 tick states of the Carrot and the Weighted controller and of the
Carrot with RK4 nodes, where the checkout has it
(tests/fixtures/torch_port_{flagship,weighted,rk4}.npz), tiled to B=512,
every other scenario infeasible; times are CUDA-event medians of 20
launches. Prints one ``TIMES <root> {"carrot": {...}, "weighted": {...},
"rk4": {...}}`` line per run and the card's name and power limit.
"""

import subprocess
import sys

_RUN = r"""
import json, os, sys
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import numpy as np, torch
import chip_smoke as cs
from eagle_mpc_tpu_torch.ops import _cuda
_cuda.build()
B = 512
tile = lambda a: torch.as_tensor(np.concatenate([a] * (B // a.shape[0])))
times = {}
for controller in [c for c in ("carrot", "weighted", "rk4") if c in cs.FIXTURES]:
    fx = np.load(os.path.join("tests", "fixtures", cs.FIXTURES[controller]))
    state = (float(fx["tick_t"][0]), tile(fx["x0"]), tile(fx["tick_xs_in"]),
             tile(fx["tick_us_in"]))
    ctrl = cs.flagship(torch.device("cuda"), torch.float32, controller)[0]
    inputs = cs.parity_inputs(ctrl, state, torch.device("cuda"),
                              torch.float32)
    calls = cs.kernel_calls(ctrl, *inputs, reg=1e-2)
    times[controller] = {name: cs._time_ms(c[0]) for name, c in calls.items()}
print("TIMES", sys.argv[1], json.dumps(times), flush=True)
"""


def main(roots):
    if not roots:
        print(__doc__)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    for root in roots:
        subprocess.run([sys.executable, "-c", _RUN, root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
