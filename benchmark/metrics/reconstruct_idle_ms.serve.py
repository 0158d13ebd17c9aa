"""Compact serving's reconstruction (infer/compact.py): device idle ms per
slice charged to `compact.reconstruct` and the spans inside it (decode,
normalisation, init, the solver and trunk): launch-bound host work
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "idle_ms", spans.RECONSTRUCT)
