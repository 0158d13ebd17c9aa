"""The conv trunk: cuDNN convolution kernels' device ms per served slice."""


def read(ctx):
    return ctx.group_ms("conv")
