"""The window-attention backward kernels: the least time of the step's
backward calls over their device time, in %."""


def read(ctx):
    return ctx.roofline("window_attn_bwd", lambda: ctx.attention_calls(True),
                        ctx.precision)
