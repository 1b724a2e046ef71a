"""K2's share of its roofline per tick, in %: the least time of the
line-search rollouts the traced ticks needed (``work/alpha_rollout.py``,
every alpha of the tick's ladder) over the device time of the kernels
named ``rollout_kernel``. ``.serve`` and ``.batch`` read it alike."""


def read(ctx):
    return ctx.roofline_pct("alpha_rollout")
