"""Compact serving's set-up (infer/compact.py): host seconds of
`CompactReconstructor` construction (the solver built and moved to the
card), the program's `compact.construct` phase (utils/tracing.py)."""

from benchmark import spans


def read(ctx):
    return spans.phase_s(ctx, ("compact.construct",))
