"""The device: 1 minus the union of kernel intervals over the profiled
stretch of serving, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
