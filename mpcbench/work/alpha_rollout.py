"""K2, the line search's rollouts: for every alpha of the tick's ladder,
the feedback law and the nonlinear step of every running node
(``ops/rollout_cuda.py``, ``csrc/rollout.cu``).

The work one solver iteration needs of one scenario is A alphas (the
ladder the tick tries, ``n_alphas``) times T node steps. Bytes: the
candidate (xs, us), the gains (k, K), the gaps, x0, the alphas, the
contraction mask and the parameters read once; each alpha's states,
controls, node costs and last state written once. Operations: the
feedback law (2 nu ndx) and, per dynamics evaluation (one under Euler,
four under RK4), the mass matrix's Cholesky factor and its two solves, and
with nc contact rows the KKT factor and solves.
"""

DEVICE_NAMES = ("rollout_kernel",)


def step_ops(s) -> int:
    nv, nc = s["nv"], s["nc"]
    return (nv ** 3 // 3 * 2 + 2 * 2 * nv * nv + 2 * 2 * nv * nv * nc
            + 2 * nc * nc * nv + nc ** 3 // 3 * 2 + 2 * 2 * nc * nc)


def work(s, iterations: int):
    """(operations, bytes) of ``iterations`` scenario-iterations."""
    T, A, nx, ndx, nu = s["T"], s["A"], s["nx"], s["ndx"], s["nu"]
    flops = iterations * A * T * (2 * nu * ndx
                                  + (4 if s["rk4"] else 1) * step_ops(s))
    reads = ((T + 1) * nx + 2 * T * nu + T * nu * ndx + (T + 1) * ndx + nx
             + A + T * s["node_dim"] + s["glob_dim"])
    writes = A * (T * nx + T * nu + T + nx)
    return flops, iterations * ((reads + writes) * s["word"] + A)
