"""The trunk: kernel launches per train step under `solver.denoise` and the
trunk's spans, forward, recompute and backward (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "launches", spans.TRUNK)
