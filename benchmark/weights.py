"""The benchmark's weights: every leaf of a model drawn from the seed on the
device, in one call.

One U(-1, 1) draw of all the leaves' elements from a `torch.Generator` on
the device, cut into the leaves and scaled as torch's default init scales
them: a weight by 1 / sqrt(fan_in), fan_in its elements per output (dim 0),
a bias by its weight's, a LayerNorm around (1, 0) by 0.1, a relative
position bias table by 0.04. The PGD step size is not drawn: it is the
configuration's fixed value. The same dict goes into the program and into
the reference.
"""

import math
from typing import Dict, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]


def _scale(name: str, shapes: Shapes) -> Tuple[float, float]:
    """(offset, scale) of a leaf's U(-1, 1) draws."""
    shape = shapes[name]
    leaf = name.rsplit(".", 1)[-1]
    if ".norm" in name:
        return (1.0, 0.1) if leaf == "weight" else (0.0, 0.1)
    if leaf == "relative_position_bias_table":
        return 0.0, 0.04
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    sibling = shapes.get(name.rsplit(".", 1)[0] + ".weight", ())
    if len(sibling) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(sibling[1:]))
    return 0.0, 0.02


def draw(shapes: Shapes, seed: int, device, fixed: Dict[str, float]
         ) -> Dict[str, torch.Tensor]:
    """float32 leaves of `shapes` from `seed`; `fixed` maps leaf names to
    constant values (the step size)."""
    names = [n for n in shapes if n not in fixed]
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out = {}
    for name, part in zip(names, torch.split(flat, sizes)):
        offset, scale = _scale(name, shapes)
        out[name] = (part * scale + offset).reshape(shapes[name])
    for name, value in fixed.items():
        out[name] = torch.full(shapes[name], float(value), device=device)
    return out
