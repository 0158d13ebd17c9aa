"""Kernel launches per train step in the profiled stretch (device copies
and sets not counted)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.launches()
