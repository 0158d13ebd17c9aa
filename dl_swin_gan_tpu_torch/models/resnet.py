"""3D ResNet denoiser, real-valued path.

Counterpart of `models/resnet.py` in the JAX package (`GatedResNet3D` with
gate "none", `ResNet3D`), with its reference quirks kept on purpose:

  - the residual of a res block is act(x), not x: the reference's in-place
    ReLU inside the pre-activation ConvBlock mutates the block input before
    the skip add (real path only);
  - time is padded circularly by (2*nres + 2) * (k - 1) // 2 frames before
    the trunk and cropped back after it;
  - the first ConvBlock has no activation; the last one has one, then the
    global residual (the padded input) is added.

The module maps complex [N, E, T, Y, X] images to themselves; inside it runs
real NCDHW with channels [re_0..re_{E-1}, im_0..im_{E-1}].
"""

from typing import Optional

import torch
from torch import nn

from dl_swin_gan_tpu_torch.models.layers import (
    ConvBlock, activation, circular_pad_time, crop_time,
)


class GatedResBlock(nn.Module):
    """Two ConvBlocks and the act(x) residual (gate 'none')."""

    def __init__(self, features: int, kernel_size: int, act_type: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_type = act_type
        self.conv0 = ConvBlock(features, features, kernel_size, act_type,
                               generator)
        self.conv1 = ConvBlock(features, features, kernel_size, act_type,
                               generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.conv0(x))
        return h + activation(x, self.act_type)


class GatedResNet3D(nn.Module):
    """3D ResNet trunk on real/imag-split channels, gate 'none'."""

    def __init__(self, num_resblocks: int = 2, num_emaps: int = 2,
                 num_features: int = 64, kernel_size: int = 3,
                 act_type: str = "relu", circular_pad: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_chans = 2 * num_emaps
        self.pad = ((2 * num_resblocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        self.head = ConvBlock(in_chans, num_features, kernel_size, "none",
                              generator)
        self.blocks = nn.ModuleList(
            GatedResBlock(num_features, kernel_size, act_type, generator)
            for _ in range(num_resblocks))
        self.tail = ConvBlock(num_features, in_chans, kernel_size, act_type,
                              generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = x.shape[1]
        h = torch.cat([x.real, x.imag], dim=1)      # [N, 2E, T, Y, X]
        h = circular_pad_time(h, self.pad)
        resid = h
        h = self.head(h)
        for block in self.blocks:
            h = block(h)
        h = self.tail(h) + resid
        h = crop_time(h, self.pad)
        return torch.complex(h[:, :e].contiguous(), h[:, e:].contiguous())


class ResNet3D(GatedResNet3D):
    """Plain 3D ResNet (the RES denoiser)."""
