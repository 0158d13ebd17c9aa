"""The train step's model FLOPs (benchmark/work/model_flops.py: batch 1,
no recomputation, times the batch) over its time in the traced run's
unprofiled window, as % of the dense tensor-core peak of the trunk's
precision (benchmark/work/peaks.py)."""


def read(ctx):
    return ctx.mfu()
