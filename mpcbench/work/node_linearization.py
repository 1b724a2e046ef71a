"""K1, the node linearization: every running node's dynamics step, cost
and their first and second derivatives (``ops/node_cuda.py``,
``csrc/node.cu``).

The work one solver iteration needs of one scenario is T nodes. Bytes:
each node's state, control and parameters read once, its outputs (cost,
next state, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu) written once, the problem's
parameters read once. Operations: the dense products each node must do, a
floor that leaves out the dynamics and the cost rows themselves: the nz
solves against the mass matrix's factor (two triangular solves of nv x nv
each, nz = ndx + nu directions), the Gauss-Newton products of the state
slots' 6 x 6 base blocks and of the frame slots' rows, and the Euler step's
base block; under RK4 four stages, each with the nz solves and the
Gauss-Newton products of every slot's rows; with nc contact rows the KKT
products per direction.
"""

DEVICE_NAMES = ("node_kernel", "node_rk4_kernel")


def node_ops(s) -> int:
    nv, ndx, nu, nc = s["nv"], s["ndx"], s["nu"], s["nc"]
    nz = ndx + nu
    kkt = nz * (2 * 3 * nc * nv + 2 * 2 * nc * nc)
    if s["rk4"]:
        return 4 * (2 * 2 * nv * nv * nz + 2 * s["n_res"] * nz * (nz + 1) + kkt)
    return (2 * 2 * nv * nv * nz + 2 * 6 * 6 * 6 * s["n_state"]
            + 2 * s["n_frame"] * ndx * (ndx + 1) + 2 * 6 * 6 * nz + kkt)


def work(s, iterations: int):
    """(operations, bytes) of ``iterations`` scenario-iterations."""
    nx, ndx, nu = s["nx"], s["ndx"], s["nu"]
    nodes = iterations * s["T"]
    outputs = 1 + nx + 2 * ndx * ndx + 2 * ndx * nu + ndx + nu + nu * nu
    words = nodes * (nx + nu + s["node_dim"] + outputs) + iterations * s["glob_dim"]
    return nodes * node_ops(s), words * s["word"]
