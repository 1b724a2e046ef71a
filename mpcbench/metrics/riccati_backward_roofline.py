"""K3's share of its roofline per tick, in %: the least time of the
backward passes the traced ticks needed (``work/riccati_backward.py``, one
per solver iteration that did work) over the device time of the kernels
named ``riccati_kernel``. ``.serve`` and ``.batch`` read it alike."""


def read(ctx):
    return ctx.roofline_pct("riccati_backward")
