"""The conv trunk (models/resnet.py, models/layers.py, the Swin convs):
cuDNN convolution kernels' device ms per train step."""


def read(ctx):
    return ctx.group_ms("conv")
