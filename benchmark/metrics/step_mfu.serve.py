"""A served slice's model FLOPs over the window's seconds per slice, as %
of the dense tensor-core peak of the trunk's precision."""


def read(ctx):
    return ctx.mfu()
