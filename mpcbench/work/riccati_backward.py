"""K3, the Riccati backward pass over the horizon (``ops/riccati_cuda.py``,
``csrc/riccati.cu``).

The work one solver iteration needs of one scenario is one pass over T
nodes. The regularization escalation's further passes would count only
where the data needs them; no counter says where it does, so none is
counted (the share is then a floor). Bytes: each node's derivatives and
gap and the terminal value read once, the gains and the value function
(k, K, Qu, Quu k, Vx, Vxx) written once. Operations: the products
Fx' Vxx Fx, Fu' Vxx Fu and Fu' Vxx Fx per node.
"""

DEVICE_NAMES = ("riccati_kernel",)


def work(s, iterations: int):
    """(operations, bytes) of ``iterations`` scenario-iterations."""
    T, ndx, nu = s["T"], s["ndx"], s["nu"]
    flops = iterations * T * (2 * 2 * ndx ** 3 + 2 * ndx * ndx * nu
                              + 2 * ndx * nu * nu + 2 * nu * ndx * ndx)
    reads = (T * (2 * ndx * ndx + 2 * ndx * nu + ndx + nu + nu * nu + ndx)
             + ndx + ndx * ndx + 2)
    writes = T * (3 * nu + nu * ndx + ndx + ndx * ndx)
    return flops, iterations * ((reads + writes) * s["word"] + 1)
