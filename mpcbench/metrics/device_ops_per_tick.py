"""Device operations (kernels, copies, sets) per tick in the traced
stretch: the captured step's replayed operations and the harness's few
copies around each tick."""


def read(ctx):
    if ctx.ticks <= 0 or ctx.summary.device_ops == 0:
        return None
    return ctx.summary.device_ops / ctx.ticks
