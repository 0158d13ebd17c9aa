"""The compact serving host path (infer/compact.py): host clock around
CompactTransform, the line padding and FlatWire.encode, in ms per slice,
mean over the slices of the traced run's window."""


def read(ctx):
    return ctx.run.get("host_transform_ms")
