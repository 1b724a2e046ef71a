"""Device time per tick, in ms, of every operation that is none of the
kernels of ``work/``: the plain PyTorch of the tick (the terminal node,
the solver's glue, the plant, the controller's update) and the harness's
few copies. ``.serve`` and ``.batch`` read it alike."""


def read(ctx):
    if ctx.ticks <= 0 or ctx.summary.device_ops == 0:
        return None
    return ctx.plain_s() / ctx.ticks * 1e3
