"""The solver's data consistency (solvers/unrolled.py): device ms per train
step of the ops under `solver.dc` (the pgd step with its SENSE normal
kernel), forward and the backward linked to it (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "device_ms", spans.DC)
