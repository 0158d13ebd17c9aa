"""Transformer pieces shared by the Swin, DiT and Latte trunks.

Counterpart of `models/dit.py` in the JAX package. So far it holds `Mlp`
(the Swin blocks use it) and `linear`, the seeded torch-default Linear the
transformer modules build on; the rest of the DiT trunk comes with the
diffusion slice.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(in_features: int, out_features: int, bias: bool = True,
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear with torch's default init, U(+-1/sqrt(fan_in)) for the
    weight and the bias, drawn from `generator` (nothing is drawn from the
    global generator)."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features, bias=bias)
    bound = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class Mlp(nn.Module):
    """Linear -> GELU -> Linear on the last dim (timm's Mlp). As in the JAX
    package, `approximate=True` is the tanh GELU (DiT, Latte) and
    `approximate=False` the exact erf one (the Swin blocks)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 approximate: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.approximate = "tanh" if approximate else "none"
        self.fc1 = linear(in_features, hidden, generator=generator)
        self.fc2 = linear(hidden, out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))
