"""The SENSE normal kernel (kernels/sense_normal.py): the least time of the
step's operator calls (benchmark/work/sense_normal.py, float32 peak or
HBM bandwidth) over its kernels' device time, in %."""


def read(ctx):
    return ctx.roofline("sense_normal", ctx.sense_calls, "float32")
