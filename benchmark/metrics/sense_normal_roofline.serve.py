"""The SENSE normal kernel: the least time of a slice's operator calls over
its kernels' device time, in %."""


def read(ctx):
    return ctx.roofline("sense_normal", ctx.sense_calls, "float32")
