"""ResNet denoisers with 1, 2 or 3 spatial axes, real or complex convs.

Counterpart of `models/resnet.py` in the JAX package (`GatedResNet3D` with
gate "none", `ResNet3D`, `ResNet2D`, `ResNet1D`), with its reference quirks
kept on purpose:

  - on the real path the residual of a res block is act(x), not x: the
    reference's in-place ReLU inside the pre-activation ConvBlock mutates
    the block input before the skip add. The complex path splits re/im into
    fresh tensors, so there the residual is x;
  - the complex path runs int(F / 1.4142) + 1 channels (46 at F = 64);
  - the first spatial axis (time for 3D and 1D, rows for 2D) is padded
    circularly by (2*nres + 2) * (k - 1) // 2 before the trunk and cropped
    back after it;
  - the first ConvBlock has no activation; the last one has one, then the
    global residual (the padded input) is added.

`dtype` is the convs' compute type (CONV_BLOCK.DTYPE; see models/layers.py):
the residuals, the padding and the activations stay float32.

The module maps complex [N, E, *spatial] to itself. The real path runs on
channels [re_0..re_{E-1}, im_0..im_{E-1}]; the complex path on the complex
channels themselves. The DSLR solver runs a 2D net on its spatial basis
[N, r*e, b, b] and a 1D net on its temporal basis [N, r, t].
"""

from typing import Optional

import torch
from torch import nn

from dl_swin_gan_tpu_torch.models.layers import (
    ConvBlock, activation, circular_pad_time, crop_time,
)


class GatedResBlock(nn.Module):
    """Two ConvBlocks and the residual (gate 'none')."""

    def __init__(self, features: int, kernel_size: int, act_type: str,
                 generator: Optional[torch.Generator] = None,
                 is_complex: bool = False, ndim: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_type = act_type
        self.is_complex = is_complex
        self.conv0 = ConvBlock(features, features, kernel_size, act_type,
                               generator, is_complex, ndim, dtype)
        self.conv1 = ConvBlock(features, features, kernel_size, act_type,
                               generator, is_complex, ndim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.conv0(x))
        return h + (x if self.is_complex else activation(x, self.act_type))


class GatedResNet3D(nn.Module):
    """ResNet trunk, gate 'none'; `ndim` spatial axes (3 for the cine
    denoiser, 2 and 1 for the DSLR nets). `num_emaps` is the number of
    complex input channels."""

    def __init__(self, num_resblocks: int = 2, num_emaps: int = 2,
                 num_features: int = 64, kernel_size: int = 3,
                 act_type: str = "relu", circular_pad: bool = True,
                 generator: Optional[torch.Generator] = None,
                 use_complex_layers: bool = False, ndim: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_complex_layers = use_complex_layers
        if use_complex_layers:
            in_chans, chans = num_emaps, int(num_features / 1.4142) + 1
        else:
            in_chans, chans = 2 * num_emaps, num_features
        self.pad = ((2 * num_resblocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        common = dict(generator=generator, is_complex=use_complex_layers,
                      ndim=ndim, dtype=dtype)
        self.head = ConvBlock(in_chans, chans, kernel_size, "none", **common)
        self.blocks = nn.ModuleList(
            GatedResBlock(chans, kernel_size, act_type, **common)
            for _ in range(num_resblocks))
        self.tail = ConvBlock(chans, in_chans, kernel_size, act_type,
                              **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = x.shape[1]
        h = x if self.use_complex_layers else torch.cat([x.real, x.imag],
                                                        dim=1)
        h = circular_pad_time(h, self.pad)
        resid = h
        h = self.head(h)
        for block in self.blocks:
            h = block(h)
        h = crop_time(self.tail(h) + resid, self.pad)
        if self.use_complex_layers:
            return h
        return torch.complex(h[:, :e].contiguous(), h[:, e:].contiguous())


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
