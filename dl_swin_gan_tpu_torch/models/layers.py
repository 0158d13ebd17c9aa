"""Shared conv layers, channels-first [N, C, *spatial] with 1, 2 or 3
spatial axes.

Counterpart of `models/layers.py` in the JAX package: `Conv` (SAME
padding, a cubic or per-axis kernel), `ComplexConv`, `SeparableConv`,
`ConvBlock`, `normalize`, `activation`, `circular_pad_time` and
`crop_time`. SAME padding is XLA's: (k - 1) // 2 before and k // 2 after
on each axis, so an even kernel pads one more after than before (an
explicit `F.pad`, as `models/discriminator.py` pads). The JAX package runs channels-last
[N, *spatial, C]; here the trunk runs torch's [N, C, *spatial], so the first
spatial axis (time for 3D and 1D, rows for 2D) is dim 2. Convolutions go to
cuDNN (the JAX package left them to XLA).

`ComplexConv` is one real convolution over the stacked [re, im] features
with the block kernel [[Kr, -Ki], [Ki, Kr]] (rows: output re, im; columns:
input re, im) and the bias [br, bi], as in the JAX package. Its parameters
stay `kernel_re`, `kernel_im`, `bias_re`, `bias_im`, so flax weights convert
one to one.

`SeparableConv` is the (2+1)D conv: a (1, k, k) conv, the activation, then
a (k, 1, 1) conv, with a middle width that keeps the parameter count of a
full k^3 conv, truncated as the JAX code truncates it.

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
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
# CONV_BLOCK.DTYPE -> the conv's compute type
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def conv_nd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            padding: Union[int, Sequence[int]],
            dtype: torch.dtype) -> torch.Tensor:
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


def normalize(x: torch.Tensor, norm_type: str = "none") -> torch.Tensor:
    """Instance norm without parameters over the spatial axes, per example
    and channel, on re and im apart when x is complex. 'batch' takes the
    same per-example statistics, as the JAX package does."""
    if norm_type == "none":
        return x
    if norm_type not in ("instance", "batch"):
        raise ValueError(f"Invalid normalization type: {norm_type}")
    if x.is_complex():
        return torch.complex(normalize(x.real, norm_type),
                             normalize(x.imag, norm_type))
    axes = tuple(range(2, x.ndim))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def _uniform(shape, fan_in: int, generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    p = nn.Parameter(torch.empty(shape))
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)
    return p


KernelSize = Union[int, Sequence[int]]


def _kernel_shape(kernel_size: KernelSize, ndim: int):
    """(kernel, SAME padding) per axis. The padding is the conv's own
    (symmetric) padding where every size is odd, else an `F.pad` argument
    for XLA's SAME: (k - 1) // 2 before and k // 2 after each axis."""
    k = ((kernel_size,) * ndim if isinstance(kernel_size, int)
         else tuple(kernel_size))
    if len(k) != ndim:
        raise ValueError(f"kernel {k} for {ndim} spatial axes")
    if all(n % 2 for n in k):
        return k, tuple(n // 2 for n in k)
    # F.pad's order: the last axis first, (before, after) each
    return k, [p for n in reversed(k) for p in ((n - 1) // 2, n // 2)]


def _same_conv(x, weight, bias, padding, dtype):
    """conv_nd with SAME padding as `_kernel_shape` gives it."""
    if isinstance(padding, tuple):
        return conv_nd(x, weight, bias, padding, dtype)
    return conv_nd(F.pad(x, padding), weight, bias, 0, dtype)


class Conv(nn.Module):
    """Real conv with SAME padding (a cubic kernel or one per axis), `ndim`
    spatial axes."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: KernelSize,
                 generator: Optional[torch.Generator] = None, ndim: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, self.padding = _kernel_shape(kernel_size, ndim)
        self.dtype = dtype
        fan_in = in_channels * math.prod(k)
        self.weight = _uniform((out_channels, in_channels, *k), fan_in,
                               generator)
        self.bias = _uniform((out_channels,), fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _same_conv(x, self.weight, self.bias, self.padding,
                          self.dtype)


class ComplexConv(nn.Module):
    """Complex conv with SAME padding as one real conv on [re, im]."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: KernelSize,
                 generator: Optional[torch.Generator] = None, ndim: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, self.padding = _kernel_shape(kernel_size, ndim)
        self.dtype = dtype
        fan_in = in_channels * math.prod(k)
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
        out = _same_conv(torch.cat([x.real, x.imag], dim=1), weight, bias,
                         self.padding, self.dtype)
        c = kr.shape[0]
        return torch.complex(out[:, :c].contiguous(), out[:, c:].contiguous())


class SeparableConv(nn.Module):
    """(2+1)D conv: spatial (1, k, k) -> activation -> temporal (k, 1, 1).
    The middle width keeps the parameters of a full k^3 conv; `int`
    truncates it, as in the JAX package."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 act_type: str = "relu",
                 generator: Optional[torch.Generator] = None,
                 is_complex: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        sp = int((k ** 3) * in_channels * out_channels
                 / ((k ** 2) * in_channels + k * out_channels))
        conv = ComplexConv if is_complex else Conv
        self.act_type = act_type
        self.spatial = conv(in_channels, sp, (1, k, k), generator, 3, dtype)
        self.temporal = conv(sp, out_channels, (k, 1, 1), generator, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal(activation(self.spatial(x), self.act_type))


class ConvBlock(nn.Module):
    """Pre-activation block: Norm -> Act -> Conv. `separable` takes effect
    with 3 spatial axes only; `norm_type` is reachable only by building a
    ConvBlock directly, as in the JAX package, whose `build_denoiser` never
    passes CONV_BLOCK.NORM on."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 act_type: str = "relu",
                 generator: Optional[torch.Generator] = None,
                 is_complex: bool = False, ndim: int = 3,
                 dtype: torch.dtype = torch.float32,
                 norm_type: str = "none", separable: bool = False):
        super().__init__()
        self.act_type = act_type
        self.norm_type = norm_type
        if separable and ndim == 3:
            self.conv = SeparableConv(in_channels, out_channels, kernel_size,
                                      act_type, generator, is_complex, dtype)
        else:
            conv = ComplexConv if is_complex else Conv
            self.conv = conv(in_channels, out_channels, kernel_size,
                             generator, ndim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(activation(normalize(x, self.norm_type),
                                    self.act_type))


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
