"""The window-attention forward kernel (kernels/window_attn.py): the least
time of the step's forward calls (benchmark/work/window_attn.py) over
its device time, in %."""


def read(ctx):
    return ctx.roofline("window_attn_fwd", lambda: ctx.attention_calls(False),
                        ctx.precision)
