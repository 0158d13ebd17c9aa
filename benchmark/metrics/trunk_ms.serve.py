"""The trunk in serving: device ms per served slice of the ops under
`solver.denoise` and the trunk's spans (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "device_ms", spans.TRUNK)
