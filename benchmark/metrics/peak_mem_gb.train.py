"""The device: torch.cuda.max_memory_allocated over the traced run's
window, after a reset, in GB."""


def read(ctx):
    if ctx.peak_allocated is None:
        return None
    return ctx.peak_allocated / 1e9
