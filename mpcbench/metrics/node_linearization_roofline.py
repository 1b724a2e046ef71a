"""K1's share of its roofline per tick, in %: the least time of the node
linearizations the traced ticks needed (``work/node_linearization.py``)
over the device time of the kernels named ``node_kernel`` /
``node_rk4_kernel``. ``.serve`` and ``.batch`` read it alike."""


def read(ctx):
    return ctx.roofline_pct("node_linearization")
