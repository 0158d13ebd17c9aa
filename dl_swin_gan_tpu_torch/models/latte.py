"""Latte, the video diffusion transformer, and LatteNet, the wrapper the
diffusion solvers build.

Counterpart of `models/latte.py` in the JAX package: per-frame 2D patch
embedding, sin-cos spatial and temporal embeddings, interleaved spatial and
temporal adaLN-Zero blocks (even blocks attend over the patches of a frame,
odd ones over the frames of a patch), the zero-init final layer, and the
unpatchify with the centre-crop-of-end-padding quirk. Kept as the JAX
package keeps them: depth is consumed in (spatial, temporal) pairs; the
temporal embedding is added only before the first temporal block; the
positional embeddings are float32 adds; LatteNet's reference defines an
SFE conv that it never calls, so Latte runs on the 2E real channels
directly and no SFE exists here. `dtype` casts the layers the JAX module
casts: the patch embedding, the blocks' attention and MLP and the final
linear (see `models/dit.py`).
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dl_swin_gan_tpu_torch.models.dit import (
    DiTBlock, FinalLayer, LabelEmbedder, TimestepEmbedder, _crop_padding,
    _sincos_1d, constant, conv_in, patch_embedding, pos_embed_2d,
    to_complex_solver_layout,
)
from dl_swin_gan_tpu_torch.models.layers import circular_pad_time, crop_time

# Latte's standard adaLN-Zero block is DiT's plain block
TransformerBlock = DiTBlock


class Latte(nn.Module):
    """Latte over channels-last [N, F, H, W, C] volumes; `extras` 1 is the
    timestep alone, 2 the timestep and a class label."""

    def __init__(self, in_channels: int = 4, hidden_size: int = 192,
                 patch_size: int = 4, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, num_classes: int = 1,
                 class_dropout_prob: float = 0.1, extras: int = 1,
                 learn_sigma: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.patch_size = patch_size
        self.extras = extras
        self.dtype = dtype
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.x_embedder = patch_embedding(in_channels, hidden_size,
                                          (patch_size, patch_size), generator)
        self.t_embedder = TimestepEmbedder(hidden_size, generator=generator)
        self.y_embedder = (LabelEmbedder(num_classes, hidden_size,
                                         class_dropout_prob, generator)
                           if extras == 2 else None)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, num_heads, mlp_ratio, generator,
                             dtype)
            for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size ** 2,
                                      self.out_channels, dtype)

    def forward(self, x, t, y=None):
        N, F_, H, W, C = x.shape
        p = self.patch_size
        D = self.hidden_size
        padH, padW = (-H) % p, (-W) % p
        Gh, Gw = (H + padH) // p, (W + padW) // p
        n_sp = Gh * Gw

        h = F.pad(x, (0, 0, 0, padW, 0, padH)).reshape(
            N * F_, H + padH, W + padW, C)
        h = conv_in(self.x_embedder, h.permute(0, 3, 1, 2),
                    self.dtype)                          # [NF, D, Gh, Gw]
        # the float32 positional add puts the stream back in float32
        tokens = h.flatten(2).transpose(1, 2)            # [NF, n_sp, D]
        tokens = tokens + constant(("pos2d", D, Gh, Gw),
                                   lambda: pos_embed_2d(D, (Gh, Gw)),
                                   x.device)[None]
        temp_embed = constant(
            ("temp", D, F_),
            lambda: _sincos_1d(D, np.arange(F_, dtype=np.float64)
                               ).astype(np.float32), x.device)[None]

        temb = self.t_embedder(t)                        # [N, D]
        c_spatial = temb.repeat_interleave(F_, dim=0)
        c_temporal = temb.repeat_interleave(n_sp, dim=0)
        if self.extras == 2:
            yemb = self.y_embedder(y)
            c_spatial = c_spatial + yemb.repeat_interleave(F_, dim=0)
            c_temporal = c_temporal + yemb.repeat_interleave(n_sp, dim=0)

        for i in range(0, len(self.blocks), 2):
            tokens = self.blocks[i](tokens, c_spatial)
            # -> temporal grouping [(N n_sp), F, D]
            tokens = tokens.reshape(N, F_, n_sp, D).transpose(1, 2).reshape(
                N * n_sp, F_, D)
            if i == 0:
                tokens = tokens + temp_embed
            tokens = self.blocks[i + 1](tokens, c_temporal)
            # -> back to spatial grouping [(N F), n_sp, D]
            tokens = tokens.reshape(N, n_sp, F_, D).transpose(1, 2).reshape(
                N * F_, n_sp, D)

        tokens = self.final_layer(tokens, c_spatial)
        h = tokens.reshape(N * F_, Gh, Gw, p, p, self.out_channels)
        h = h.permute(0, 1, 3, 2, 4, 5).reshape(N * F_, Gh * p, Gw * p,
                                                self.out_channels)
        h = _crop_padding(h, (H, W), (padH, padW), 1)
        return h.reshape(N, F_, H, W, self.out_channels)


class LatteNet(nn.Module):
    """Latte on the 2E real/imag channels of a complex [N, E, T, Y, X]
    volume, the time axis padded circularly (`num_blocks` sets the pad
    extent only)."""

    def __init__(self, num_emaps: int = 2, hidden_size: int = 192,
                 depth: int = 12, num_heads: int = 6, patch_size: int = 4,
                 num_blocks: int = 2, kernel_size: int = 3,
                 circular_pad: bool = True, learn_sigma: bool = False,
                 num_classes: int = 1,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.learn_sigma = learn_sigma
        self.pad = ((2 * num_blocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        self.latte = Latte(in_channels=2 * num_emaps, hidden_size=hidden_size,
                           patch_size=patch_size, depth=depth,
                           num_heads=num_heads, learn_sigma=learn_sigma,
                           num_classes=num_classes, generator=generator,
                           dtype=dtype)

    def forward(self, x, t, y):
        h = circular_pad_time(torch.cat([x.real, x.imag], dim=1), self.pad)
        h = self.latte(h.permute(0, 2, 3, 4, 1), t, y).permute(0, 4, 1, 2, 3)
        return to_complex_solver_layout(crop_time(h, self.pad),
                                        self.learn_sigma)
