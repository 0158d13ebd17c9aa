"""ResNet denoisers with 1, 2 or 3 spatial axes, real or complex convs, and
their squeeze-excitation (SE) and CBAM gates.

Counterpart of `models/resnet.py` in the JAX package (`GatedResNet3D`,
`ChannelGate`, `SpatialGate`, `ResNet3D`, `ResNet2D`, `ResNet1D`), with its
reference quirks kept on purpose:

  - on the real path the residual of a res block is act(x), not x: the
    reference's in-place ReLU inside the pre-activation ConvBlock mutates
    the block input before the skip add. The complex path splits re/im into
    fresh tensors, so there the residual is x;
  - the complex path runs int(F / 1.4142) + 1 channels (46 at F = 64);
  - the first spatial axis (time for 3D and 1D, rows for 2D) is padded
    circularly by (2*nres + 2) * (k - 1) // 2 before the trunk and cropped
    back after it;
  - the first ConvBlock has no activation; the last one has one, then the
    global residual (the padded input) is added;
  - the SE gate (gate 'se') is global average pool -> FC to `reduction`
    (an absolute hidden width, not a divisor) -> ReLU -> FC back ->
    sigmoid, the same real FCs on re and im apart; it multiplies the block
    output (a complex product on the complex path) before the residual add;
  - CBAM (gate 'cbam') is that channel gate, then a spatial gate: the
    channel mean -> a k=5 conv, multiplied in with no sigmoid;
  - the gates stay float32 under a bfloat16 conv trunk (their FCs and conv
    have no dtype in the JAX code);
  - CONV_BLOCK.SEPARABLE applies to the 3D trunk only.

`dtype` is the convs' compute type (CONV_BLOCK.DTYPE; see models/layers.py):
the residuals, the padding and the activations stay float32.

The module maps complex [N, E, *spatial] to itself. The real path runs on
channels [re_0..re_{E-1}, im_0..im_{E-1}]; the complex path on the complex
channels themselves. The DSLR solver runs a 2D net on its spatial basis
[N, r*e, b, b] and a 1D net on its temporal basis [N, r, t].
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dl_swin_gan_tpu_torch.models.layers import (
    ComplexConv, Conv, ConvBlock, _uniform, activation, circular_pad_time,
    crop_time,
)
from dl_swin_gan_tpu_torch.utils.tracing import span

GATES = ("none", "se", "cbam")


def _split_apply(fn, x: torch.Tensor) -> torch.Tensor:
    """A real function on re and im apart when x is complex."""
    if x.is_complex():
        return torch.complex(fn(x.real), fn(x.imag))
    return fn(x)


class ChannelGate(nn.Module):
    """SE / CBAM channel gate: GAP -> FC -> ReLU -> FC -> sigmoid, as
    [N, C, 1, ...]. The FCs are torch's Linear default init."""

    def __init__(self, channels: int, reduction: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.utils.skip_init(nn.Linear, channels, reduction)
        self.fc2 = nn.utils.skip_init(nn.Linear, reduction, channels)
        for fc, fan_in in ((self.fc1, channels), (self.fc2, reduction)):
            fc.weight = _uniform(fc.weight.shape, fan_in, generator)
            fc.bias = _uniform(fc.bias.shape, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.mean(tuple(range(2, x.ndim)))              # [N, C]
        g = _split_apply(self.fc1, g)
        g = _split_apply(F.relu, g)
        g = _split_apply(self.fc2, g)
        g = _split_apply(torch.sigmoid, g)
        return g.reshape(g.shape + (1,) * (x.ndim - 2))


class SpatialGate(nn.Module):
    """CBAM spatial gate: channel mean -> k=5 conv (no sigmoid), as
    [N, 1, *spatial]."""

    def __init__(self, is_complex: bool, ndim: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        conv = ComplexConv if is_complex else Conv
        self.conv = conv(1, 1, 5, generator, ndim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.mean(1, keepdim=True))


class GatedResBlock(nn.Module):
    """Two ConvBlocks, the optional channel and spatial gates, and the
    residual."""

    def __init__(self, features: int, kernel_size: int, act_type: str,
                 generator: Optional[torch.Generator] = None,
                 is_complex: bool = False, ndim: int = 3,
                 dtype: torch.dtype = torch.float32, gate: str = "none",
                 reduction: int = 16, separable: bool = False):
        super().__init__()
        if gate not in GATES:
            raise ValueError(f"Unknown gate: {gate!r}")
        self.act_type = act_type
        self.is_complex = is_complex
        common = dict(generator=generator, is_complex=is_complex, ndim=ndim,
                      dtype=dtype, separable=separable)
        self.conv0 = ConvBlock(features, features, kernel_size, act_type,
                               **common)
        self.conv1 = ConvBlock(features, features, kernel_size, act_type,
                               **common)
        self.channel_gate = (ChannelGate(features, reduction, generator)
                             if gate in ("se", "cbam") else None)
        self.spatial_gate = (SpatialGate(is_complex, ndim, generator)
                             if gate == "cbam" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.conv0(x))
        if self.channel_gate is not None:
            h = h * self.channel_gate(h)
        if self.spatial_gate is not None:
            h = h * self.spatial_gate(h)
        return h + (x if self.is_complex else activation(x, self.act_type))


class GatedResNet3D(nn.Module):
    """ResNet trunk with `gate` 'none', 'se' or 'cbam' in its res blocks;
    `ndim` spatial axes (3 for the cine denoiser, 2 and 1 for the DSLR
    nets). `num_emaps` is the number of complex input channels."""

    def __init__(self, num_resblocks: int = 2, num_emaps: int = 2,
                 num_features: int = 64, kernel_size: int = 3,
                 act_type: str = "relu", circular_pad: bool = True,
                 generator: Optional[torch.Generator] = None,
                 use_complex_layers: bool = False, ndim: int = 3,
                 dtype: torch.dtype = torch.float32, gate: str = "none",
                 reduction: int = 16, separable: bool = False):
        super().__init__()
        self.use_complex_layers = use_complex_layers
        if use_complex_layers:
            in_chans, chans = num_emaps, int(num_features / 1.4142) + 1
        else:
            in_chans, chans = 2 * num_emaps, num_features
        self.pad = ((2 * num_resblocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        common = dict(generator=generator, is_complex=use_complex_layers,
                      ndim=ndim, dtype=dtype, separable=separable)
        self.head = ConvBlock(in_chans, chans, kernel_size, "none", **common)
        self.blocks = nn.ModuleList(
            GatedResBlock(chans, kernel_size, act_type, gate=gate,
                          reduction=reduction, **common)
            for _ in range(num_resblocks))
        self.tail = ConvBlock(chans, in_chans, kernel_size, act_type,
                              **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = x.shape[1]
        with span("trunk.head"):
            h = x if self.use_complex_layers else torch.cat([x.real, x.imag],
                                                            dim=1)
            h = circular_pad_time(h, self.pad)
            resid = h
            h = self.head(h)
        for block in self.blocks:
            with span("trunk.block"):
                h = block(h)
        with span("trunk.tail"):
            h = crop_time(self.tail(h) + resid, self.pad)
            if self.use_complex_layers:
                return h
            return torch.complex(h[:, :e].contiguous(),
                                 h[:, e:].contiguous())


class ResNet3D(GatedResNet3D):
    """Plain 3D ResNet (the RES denoiser)."""


class ResNet2D(GatedResNet3D):
    """Plain 2D ResNet: the DSLR spatial basis net."""

    def __init__(self, **kwargs):
        super().__init__(ndim=2, **kwargs)


class ResNet1D(GatedResNet3D):
    """Plain 1D ResNet: the DSLR temporal basis net."""

    def __init__(self, **kwargs):
        super().__init__(ndim=1, **kwargs)
