"""The conv trunk: cuDNN's layout-transpose kernels (NCDHW <-> NDHWC)
device ms per train step."""


def read(ctx):
    return ctx.group_ms("conv_transpose")
