"""The model step: elementwise and reduction kernels' device ms per train
step."""


def read(ctx):
    return ctx.group_ms("elementwise")
