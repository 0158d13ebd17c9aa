"""The device pipeline's stretch of a step (data/device_pipeline.py): CUDA
events around each step's host draws, builds on the card and stack, in
ms per step, mean over the unprofiled window of the traced run."""


def read(ctx):
    return ctx.run.get("pipeline_build_ms")
