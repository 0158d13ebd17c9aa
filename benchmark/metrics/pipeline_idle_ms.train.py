"""The device pipeline (data/device_pipeline.py): device idle ms per train
step charged to `pipeline.draw` (the host draws) and `pipeline.build`
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "idle_ms", spans.PIPELINE)
