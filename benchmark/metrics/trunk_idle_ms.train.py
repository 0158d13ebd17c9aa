"""The trunk: device idle ms per train step charged to the trunk's spans (the
host launching the trunk, its recompute or its backward, too slowly to keep
the card busy; benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "idle_ms", spans.TRUNK)
