"""The Swin trunk (models/swin.py): cuBLAS GEMM kernels' device ms per
train step (its linear layers, forward, recompute and backward)."""


def read(ctx):
    return ctx.group_ms("gemm")
