"""The trunk (models/resnet.py, models/swin.py): device ms per train step of
the ops under the solver's `solver.denoise` spans and the trunk's own
(`trunk.*`, `swin.*`): the forward, remat's recompute and the backward
linked to them (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "device_ms", spans.TRUNK)
