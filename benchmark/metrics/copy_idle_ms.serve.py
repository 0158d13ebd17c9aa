"""Compact serving's copies (infer/compact.py): device idle ms per slice
charged to `compact.upload` (the wire buffer to the card) and
`compact.readback` (the image to the host; benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.read(ctx, "idle_ms", spans.COPIES)
