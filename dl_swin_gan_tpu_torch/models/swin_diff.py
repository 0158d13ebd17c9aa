"""SwinDiffNet: the time-conditioned Swin denoiser for diffusion
reconstruction.

Counterpart of `models/swin_diff.py` in the JAX package: the SwinIR-style
trunk of `models/swin.py` with FiLM (scale, shift) conditioning on the
timestep and label embeddings around each Swin trunk, with the (x, t, y)
signature the diffusion solvers call. Its window attention goes through
`kernels.window_attn.window_attention`, so this is the diffusion path that
launches both window-attention kernels (the backward when training).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dl_swin_gan_tpu_torch.models.dit import (
    LabelEmbedder, TimestepEmbedder, dense, to_complex_solver_layout,
)
from dl_swin_gan_tpu_torch.models.layers import (
    ConvBlock, circular_pad_time, crop_time,
)
from dl_swin_gan_tpu_torch.models.swin import SwinTransformer3D


class SwinDiffNet(nn.Module):
    """(x, t, y) -> x: SFE conv -> N x [FiLM -> Swin -> FiLM -> ConvBlock
    + residual] -> output ConvBlock."""

    def __init__(self, num_swinblocks: int = 1, num_emaps: int = 2,
                 hidden_size: int = 96, kernel_size: int = 3,
                 depths: Tuple[int, ...] = (2,),
                 num_heads: Tuple[int, ...] = (4,),
                 window_size: Tuple[int, int, int] = (7, 8, 8),
                 patch_size: Tuple[int, int, int] = (4, 4, 4),
                 num_blocks: int = 2, num_classes: int = 1,
                 learn_sigma: bool = False, circular_pad: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_chans = 2 * num_emaps
        chans = hidden_size
        self.learn_sigma = learn_sigma
        self.pad = ((2 * num_blocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        self.t_embedder = TimestepEmbedder(chans, generator=generator)
        self.y_embedder = LabelEmbedder(num_classes, chans, 0.1, generator)
        self.sfe = ConvBlock(in_chans, chans, kernel_size, "none", generator)
        self.film_in = nn.ModuleList(dense(chans, 2 * chans, "zeros")
                                     for _ in range(num_swinblocks))
        self.trunks = nn.ModuleList(
            SwinTransformer3D(chans, chans, patch_size, depths, num_heads,
                              window_size, drop_path_rate=0.0,
                              generator=generator)
            for _ in range(num_swinblocks))
        self.film_out = nn.ModuleList(dense(chans, 2 * chans, "zeros")
                                      for _ in range(num_swinblocks))
        self.convs = nn.ModuleList(
            ConvBlock(chans, chans, kernel_size, "relu", generator)
            for _ in range(num_swinblocks))
        self.final_layer = ConvBlock(chans, in_chans * (2 if learn_sigma
                                                        else 1),
                                     kernel_size, "relu", generator)

    @staticmethod
    def _film(v, mod):
        scale, shift = torch.chunk(mod, 2, dim=-1)
        bc = (slice(None), slice(None)) + (None,) * (v.ndim - 2)
        return v * (1 + scale[bc]) + shift[bc]

    def forward(self, x, t, y):
        h = circular_pad_time(torch.cat([x.real, x.imag], dim=1), self.pad)
        c = F.silu(self.t_embedder(t) + self.y_embedder(y))
        h = self.sfe(h)
        res = h
        for film_in, trunk, film_out, conv in zip(
                self.film_in, self.trunks, self.film_out, self.convs):
            h = self._film(h, film_in(c))
            h = trunk(h.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
            h = self._film(h, film_out(c))
            h = conv(h) + res
            res = h
        h = crop_time(self.final_layer(h), self.pad)
        return to_complex_solver_layout(h, self.learn_sigma)
