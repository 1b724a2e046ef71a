"""The device's idle share, in %.

Where the window's replays were timed by CUDA events (the ``graph``
route), it is 100 minus their spans' sum over the untraced window's wall
time: the share in which no replay was on the device, free of the
profiler's cost; idle inside a replay, while the host is still launching
the graph, is not seen. Elsewhere (the ``eager`` route, where a replay
spans the host's own pacing) it is 100 minus the union of the device
operations' intervals over the traced stretch's wall time. ``.serve`` and
``.batch`` read it alike."""


def read(ctx):
    w = ctx.window
    if w is not None and w.replay_s is not None and w.seconds > 0:
        return 100.0 * (1.0 - w.replay_s / w.seconds)
    if ctx.summary.device_ops == 0 or ctx.summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.summary.busy_s / ctx.summary.window_s)
