"""Shared conv layers, channels-first [N, C, *spatial] with 1, 2 or 3
spatial axes.

Counterpart of `models/layers.py` in the JAX package: `Conv` (SAME
padding), `ComplexConv`, `ConvBlock` with no normalization, `activation`,
`circular_pad_time` and `crop_time`. The JAX package runs channels-last
[N, *spatial, C]; here the trunk runs torch's [N, C, *spatial], so the first
spatial axis (time for 3D and 1D, rows for 2D) is dim 2. Convolutions go to
cuDNN (the JAX package left them to XLA).

`ComplexConv` is one real convolution over the stacked [re, im] features
with the block kernel [[Kr, -Ki], [Ki, Kr]] (rows: output re, im; columns:
input re, im) and the bias [br, bi], as in the JAX package. Its parameters
stay `kernel_re`, `kernel_im`, `bias_re`, `bias_im`, so flax weights convert
one to one.

Weights are initialised as torch's own nn.Conv default, from an explicit
generator: U(+-1/sqrt(fan_in)) for the kernel and the bias, with fan_in the
(complex) input channels times the kernel volume. The JAX package's init
draws from the same distribution.

`dtype` (CONV_BLOCK.DTYPE) is the element type the convolution computes in,
with the JAX package's `conv_nd` semantics: the input and the kernel are
cast to it, the conv runs in it (cuDNN accumulates bfloat16 in float32), the
output is cast back to float32 and then the float32 bias is added.
Parameters, activations, padding and cropping stay float32. The cast is
explicit per conv, not `torch.autocast`, which would keep the activations
between the convs in bfloat16.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
# CONV_BLOCK.DTYPE -> the conv's compute type
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def conv_nd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            padding: int, dtype: torch.dtype) -> torch.Tensor:
    """SAME conv of `weight.ndim - 2` spatial axes computed in `dtype`, then
    the bias added in float32 (one fused call when `dtype` is float32)."""
    conv = _CONV[weight.ndim - 2]
    if dtype == torch.float32:
        return conv(x, weight, bias, padding=padding)
    out = conv(x.to(dtype), weight.to(dtype), padding=padding)
    return out.float() + bias.reshape((-1,) + (1,) * (out.ndim - 2))


def activation(x: torch.Tensor, act_type: str = "relu") -> torch.Tensor:
    """The activation, on re and im apart when x is complex."""
    if act_type == "none":
        return x
    if x.is_complex():
        return torch.complex(activation(x.real, act_type),
                             activation(x.imag, act_type))
    if act_type == "relu":
        return F.relu(x)
    if act_type == "leaky_relu":
        return F.leaky_relu(x, 0.01)   # flax's default slope
    raise ValueError(f"Invalid activation type: {act_type}")


def _uniform(shape, fan_in: int, generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    p = nn.Parameter(torch.empty(shape))
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)
    return p


def _check_kernel_size(kernel_size: int) -> None:
    if kernel_size % 2 != 1:
        raise NotImplementedError(
            "only odd conv kernel sizes are ported (SAME padding)")


class Conv(nn.Module):
    """Real conv with SAME padding (odd kernel sizes), `ndim` spatial axes."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: Optional[torch.Generator] = None, ndim: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_kernel_size(kernel_size)
        k = (kernel_size,) * ndim
        self.padding = kernel_size // 2
        self.dtype = dtype
        fan_in = in_channels * kernel_size ** ndim
        self.weight = _uniform((out_channels, in_channels, *k), fan_in,
                               generator)
        self.bias = _uniform((out_channels,), fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nd(x, self.weight, self.bias, self.padding, self.dtype)


class ComplexConv(nn.Module):
    """Complex conv with SAME padding as one real conv on [re, im]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: Optional[torch.Generator] = None, ndim: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_kernel_size(kernel_size)
        k = (kernel_size,) * ndim
        self.padding = kernel_size // 2
        self.dtype = dtype
        fan_in = in_channels * kernel_size ** ndim
        shape = (out_channels, in_channels, *k)
        self.kernel_re = _uniform(shape, fan_in, generator)
        self.kernel_im = _uniform(shape, fan_in, generator)
        self.bias_re = _uniform((out_channels,), fan_in, generator)
        self.bias_im = _uniform((out_channels,), fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kr, ki = self.kernel_re, self.kernel_im
        weight = torch.cat([torch.cat([kr, -ki], dim=1),
                            torch.cat([ki, kr], dim=1)], dim=0)
        bias = torch.cat([self.bias_re, self.bias_im])
        out = conv_nd(torch.cat([x.real, x.imag], dim=1), weight, bias,
                      self.padding, self.dtype)
        c = kr.shape[0]
        return torch.complex(out[:, :c].contiguous(), out[:, c:].contiguous())


class ConvBlock(nn.Module):
    """Pre-activation block: Act -> Conv (normalization 'none')."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 act_type: str = "relu",
                 generator: Optional[torch.Generator] = None,
                 is_complex: bool = False, ndim: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_type = act_type
        conv = ComplexConv if is_complex else Conv
        self.conv = conv(in_channels, out_channels, kernel_size, generator,
                         ndim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(activation(x, self.act_type))


def circular_pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the first spatial axis (dim 2) by `pad` on both sides with
    wrap-around, as numpy's mode 'wrap' does (also when pad exceeds the
    axis); the cine cycle is periodic."""
    if pad == 0:
        return x
    n = x.shape[2]
    idx = torch.arange(-pad, n + pad, device=x.device) % n
    return x.index_select(2, idx)


def crop_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    return x[:, :, pad:-pad]
