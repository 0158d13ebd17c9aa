"""Shared conv layers (real path), NCDHW inside.

Counterpart of `models/layers.py` in the JAX package, for real-valued convs:
`Conv` (SAME padding), `ConvBlock` with no normalization, `activation`,
`circular_pad_time` and `crop_time`. The JAX package runs channels-last
[N, T, Y, X, C]; here the trunk runs torch's [N, C, T, Y, X], so the time
axis is dim 2. Convolutions go to cuDNN (the JAX package left them to XLA).

Weights are initialised as torch's own nn.Conv3d default, from an explicit
generator: U(+-1/sqrt(fan_in)) for the kernel and the bias. The JAX
package's init draws from the same distribution.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def activation(x: torch.Tensor, act_type: str = "relu") -> torch.Tensor:
    if act_type == "none":
        return x
    if act_type == "relu":
        return F.relu(x)
    if act_type == "leaky_relu":
        return F.leaky_relu(x, 0.01)   # flax's default slope
    raise ValueError(f"Invalid activation type: {act_type}")


class Conv(nn.Module):
    """Real 3D conv with SAME padding (odd kernel sizes), NCDHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise NotImplementedError(
                "only odd conv kernel sizes are ported (SAME padding)")
        k = (kernel_size,) * 3
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels * kernel_size ** 3)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, self.bias, padding=self.padding)


class ConvBlock(nn.Module):
    """Pre-activation block: Act -> Conv (normalization 'none')."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 act_type: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_type = act_type
        self.conv = Conv(in_channels, out_channels, kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(activation(x, self.act_type))


def circular_pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Circularly pad the time axis (dim 2 of NCDHW) by `pad` on both sides;
    the cine cycle is periodic."""
    if pad == 0:
        return x
    return F.pad(x, (0, 0, 0, 0, pad, pad), mode="circular")


def crop_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    return x[:, :, pad:-pad]
