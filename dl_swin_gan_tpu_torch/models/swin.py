"""Video Swin Transformer 3D denoiser (SwinIR-style wrapper).

Counterpart of `models/swin.py` in the JAX package, with its reference
quirks kept on purpose:

  - `get_window_size` shrinks the window and zeroes the shift on every axis
    not larger than the window;
  - the attention module is built with the configured window size and
    slices the relative-position index [:N, :N] when the window shrank,
    which picks other bias entries than re-deriving the index would;
  - a block pads to window multiples, then rolls by -shift (the mask is
    built on the padded dims), and afterwards rolls back and crops;
  - `SwinNet3D` adds the deep-feature input twice (`h + dfe_in`, then
    `dfe_in + h`), pads time circularly by (2 * swinblocks + 2) * (k - 1)
    // 2 frames, and its SFE conv has no activation;
  - the patch unembedding is flax's `ConvTranspose` (no kernel flip; the
    converter flips the kernel for torch's `conv_transpose3d`) followed by
    a centred crop.

The Swin trunk runs channels-last [B, D, H, W, C] as the JAX package does:
`nn.Linear` and `nn.LayerNorm(eps=1e-5)` act on the last dim. Only the
convolutions (the ConvBlocks, the stride-4 patch embedding and the
transposed-conv unembedding) see torch's NCDHW. Window attention goes
through `kernels.window_attn.window_attention`: the hand-written kernel on
the GPU, its plain version on the CPU.

`dtype` (CONV_BLOCK.DTYPE) casts what the JAX modules cast: the attention's
qkv and proj and the MLPs (flax `Dense(dtype=)`, `models.dit.Linear`), so
window attention takes bfloat16 q, k, v with a float32 bias table and mask
and returns bfloat16; the patch embedding and unembedding and
PatchMerging's and PatchExpand's linears, each cast back to float32 after;
the ConvBlocks through `layers.conv_nd`. The LayerNorms and the residual
stream stay float32: a bfloat16 branch added to the float32 shortcut
promotes to float32, as in jnp. Parameters stay float32.
"""

import functools
import math
from functools import reduce
from operator import mul
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dl_swin_gan_tpu_torch.kernels.window_attn import window_attention
from dl_swin_gan_tpu_torch.models.dit import (
    LabelEmbedder, Mlp, conv_in, linear, rank_rand,
)
from dl_swin_gan_tpu_torch.models.layers import (
    ConvBlock, circular_pad_time, crop_time,
)
from dl_swin_gan_tpu_torch.parallel.mesh import head_columns
from dl_swin_gan_tpu_torch.utils.tracing import span


def LayerNorm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


# ---------------------------------------------------------------- helpers

def get_window_size(x_size, window_size, shift_size=None):
    """Shrink the window (and zero the shift) on axes not larger than the
    window."""
    use_ws = list(window_size)
    use_ss = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_ws[i] = x_size[i]
            if use_ss is not None:
                use_ss[i] = 0
    if shift_size is None:
        return tuple(use_ws)
    return tuple(use_ws), tuple(use_ss)


def window_partition(x: torch.Tensor,
                     ws: Tuple[int, int, int]) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, reduce(mul, ws), C)


def window_reverse(windows: torch.Tensor, ws: Tuple[int, int, int], B: int,
                   D: int, H: int, W: int) -> torch.Tensor:
    """Inverse of window_partition."""
    x = windows.reshape(B, D // ws[0], H // ws[1], W // ws[2],
                        ws[0], ws[1], ws[2], -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def compute_shift_mask(Dp: int, Hp: int, Wp: int, ws, ss) -> np.ndarray:
    """Static shifted-window attention mask [nW, N, N] of 0 / -100."""
    img = np.zeros((1, Dp, Hp, Wp, 1), np.float32)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0] or None),
              slice(-ss[0] or Dp, None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1] or None),
                  slice(-ss[1] or Hp, None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2] or None),
                      slice(-ss[2] or Wp, None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    m = window_partition(torch.from_numpy(img), ws)[..., 0].numpy()  # [nW, N]
    attn = m[:, None, :] - m[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


def _relative_position_index(ws) -> np.ndarray:
    """Static [N, N] index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]),
                                  np.arange(ws[2]), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= (2 * ws[2] - 1)
    return rel.sum(-1)


# the mask and the index are constants per shape, built once per device, and
# built as normal tensors even when the first call runs under
# torch.inference_mode (serving): autograd may not save an inference tensor,
# so a cached one would break every later train step
@functools.lru_cache(maxsize=32)
def _shift_mask(dims, ws, ss, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(compute_shift_mask(*dims, ws, ss)).to(device)


@functools.lru_cache(maxsize=32)
def _bias_index(ws, n: int, device) -> torch.Tensor:
    index = _relative_position_index(ws)[:n, :n].reshape(-1)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(index)).to(device)


# ---------------------------------------------------------------- modules

class DropPath(nn.Module):
    """Stochastic depth (per-sample residual drop): the identity in eval
    mode; in train mode it draws its keep mask from `self.generator`, and
    raises if it has none. The weights' init generator is not it: the
    trainer owns a CPU generator for the draws and hands it to every
    DropPath (`set_dropout_generator`), and the solver's remat replays the
    draws in its recompute (`solvers/unrolled.py`)."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator
        self.shard = (0, 1)     # set with the generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in training mode needs a generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        draw = rank_rand(shape, self.generator, self.shard)
        return torch.where((draw < keep).to(x.device), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator],
                          shard=(0, 1)) -> None:
    """Give every DropPath and LabelEmbedder under `module` the generator
    its draws come from, and the data-parallel rank's (index, count) of
    the batch (`models.dit.rank_rand`)."""
    for m in module.modules():
        if isinstance(m, (DropPath, LabelEmbedder)):
            m.generator = generator
            m.shard = shard


class WindowAttention3D(nn.Module):
    """W-MSA with a 3D relative-position bias, on [B*nW, N, C] windows."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 num_heads: int, qkv_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = tuple(window_size)
        # this rank's heads: all of them, or H / tp under tensor parallelism
        # (parallel/mesh.py apply_tp, which also sets head_range: the
        # table's columns this rank reads)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.head_range = None
        ws = self.window_size
        table_len = (2 * ws[0] - 1) * (2 * ws[1] - 1) * (2 * ws[2] - 1)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(table_len, num_heads))
        with torch.no_grad():   # flax's truncated_normal(0.02): cut at 2 std
            nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                                  a=-0.04, b=0.04, generator=generator)
        self.qkv = linear(dim, 3 * dim, bias=qkv_bias, generator=generator,
                          dtype=dtype)
        self.proj = linear(dim, dim, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bn, N, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(Bn, N, 3, h, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4).contiguous()   # [3, Bn, h, N, hd]
        index = _bias_index(self.window_size, N, x.device)
        table = head_columns(self.relative_position_bias_table,
                             self.head_range)
        bias = table[index].reshape(N, N, h)
        bias = bias.permute(2, 0, 1).contiguous()       # [h, N, N]
        out = window_attention(qkv[0], qkv[1], qkv[2], bias, mask)
        return self.proj(out.transpose(1, 2).reshape(Bn, N, h * hd))


class SwinBlock3D(nn.Module):
    """One (shifted-)window attention + MLP block, channels-last."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int] = (2, 7, 7),
                 shift_size: Tuple[int, int, int] = (0, 0, 0),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, window_size, num_heads, qkv_bias,
                                      generator, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, approximate=False,
                       generator=generator, dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        ws, ss = get_window_size((D, H, W), self.window_size, self.shift_size)
        shifted = any(s > 0 for s in ss)

        with span("swin.attn"):
            shortcut = x
            h = self.norm1(x)
            pd, ph, pw = (-D) % ws[0], (-H) % ws[1], (-W) % ws[2]
            h = F.pad(h, (0, 0, 0, pw, 0, ph, 0, pd))
            _, Dp, Hp, Wp, _ = h.shape
            mask = None
            if shifted:
                h = torch.roll(h, (-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
                mask = _shift_mask((Dp, Hp, Wp), ws, ss, h.device)
            h = self.attn(window_partition(h, ws), mask)
            h = window_reverse(h, ws, B, Dp, Hp, Wp)
            if shifted:
                h = torch.roll(h, ss, dims=(1, 2, 3))
            if pd or ph or pw:
                h = h[:, :D, :H, :W]
            x = shortcut + self.drop_path(h)
        with span("swin.mlp"):
            return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 spatial downsample: gather 4 -> norm -> linear 4C -> 2C."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = linear(4 * dim, 2 * dim, bias=False,
                                generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x)).float()


class PatchExpand(nn.Module):
    """2x2 spatial upsample: linear C -> 2C -> pixel shuffle to C/2 channels
    -> centred crop -> norm."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.expand = linear(dim, 2 * dim, bias=False, generator=generator,
                             dtype=dtype)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x: torch.Tensor,
                target_hw: Tuple[int, int]) -> torch.Tensor:
        B, D, H, W, _ = x.shape
        x = self.expand(x).float()
        c = x.shape[-1] // 4
        x = x.reshape(B, D, H, W, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(B, D, 2 * H, 2 * W, c)
        th, tw = target_hw
        sh, sw = (2 * H - th) // 2, (2 * W - tw) // 2
        return self.norm(x[:, :, sh:sh + th, sw:sw + tw])


class BasicLayer(nn.Module):
    """One Swin stage: `depth` blocks alternating no shift / half-window
    shift, then an optional PatchMerging."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Tuple[int, int, int] = (1, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: Sequence[float] = (), downsample: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        shift = tuple(w // 2 for w in window_size)
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, num_heads, window_size,
                        (0, 0, 0) if i % 2 == 0 else shift, mlp_ratio,
                        qkv_bias,
                        drop_path[i] if i < len(drop_path) else 0.0,
                        generator, dtype)
            for i in range(depth))
        self.downsample = (PatchMerging(dim, generator, dtype) if downsample
                           else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


def _init_conv(layer, fan_in: int, generator):
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class SwinTransformer3D(nn.Module):
    """U-shaped (or flat) video Swin backbone, image to image, channels-last
    [B, D, H, W, C_in] in and out."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 96,
                 patch_size: Tuple[int, int, int] = (4, 4, 4),
                 depths: Tuple[int, ...] = (6,),
                 num_heads: Tuple[int, ...] = (8,),
                 window_size: Tuple[int, int, int] = (2, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.2,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ps = tuple(patch_size)
        self.patch_size = ps
        self.dtype = dtype
        n = len(depths)
        k3 = ps[0] * ps[1] * ps[2]
        self.patch_embed = _init_conv(
            nn.utils.skip_init(nn.Conv3d, in_chans, embed_dim, ps, stride=ps),
            in_chans * k3, generator)
        total = sum(depths)
        dpr = list(np.linspace(0, drop_path_rate, total)) if total > 1 \
            else [0.0]
        self.layers = nn.ModuleList(
            BasicLayer(int(embed_dim * 2 ** i), depths[i], num_heads[i],
                       window_size, mlp_ratio, qkv_bias,
                       dpr[sum(depths[:i]):sum(depths[:i + 1])],
                       downsample=i < n - 1, generator=generator,
                       dtype=dtype)
            for i in range(n))
        self.expands = nn.ModuleList(
            PatchExpand(int(embed_dim * 2 ** (n - j - 1)), generator, dtype)
            for j in range(n - 1))
        # torch's ConvTranspose3d default init takes fan_in from the weight's
        # dim 1 (out channels)
        self.patch_unembed = _init_conv(
            nn.utils.skip_init(nn.ConvTranspose3d, embed_dim, in_chans, ps,
                               stride=ps),
            in_chans * k3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D0, H0, W0, _ = x.shape
        ps = self.patch_size
        h = F.pad(x, (0, 0, 0, (-W0) % ps[2], 0, (-H0) % ps[1],
                      0, (-D0) % ps[0]))
        h = conv_in(self.patch_embed, h.permute(0, 4, 1, 2, 3), self.dtype)
        h = h.float().permute(0, 2, 3, 4, 1)

        sizes = []
        for i, layer in enumerate(self.layers):
            if i < len(self.layers) - 1:
                sizes.append(h.shape)
            h = layer(h)
        for j, expand in enumerate(self.expands):
            target = sizes[len(self.layers) - j - 2]
            h = expand(h, (target[2], target[3]))

        h = conv_in(self.patch_unembed, h.permute(0, 4, 1, 2, 3), self.dtype)
        h = h.float().permute(0, 2, 3, 4, 1)
        dd, dh, dw = h.shape[1] - D0, h.shape[2] - H0, h.shape[3] - W0
        return h[:, math.ceil(dd / 2):h.shape[1] - dd // 2,
                 math.ceil(dh / 2):h.shape[2] - dh // 2,
                 math.ceil(dw / 2):h.shape[3] - dw // 2]


class SwinNet3D(nn.Module):
    """SwinIR-layout denoiser: SFE conv -> N x [Swin + ConvBlock residual] ->
    ConvBlock, the deep-feature skip added twice -> output ConvBlock.

    Complex [N, E, T, Y, X] in and out; inside, real channels [re_0 ..
    re_{E-1}, im_0 .. im_{E-1}], NCDHW around the convs and channels-last
    through the Swin trunks.
    """

    def __init__(self, num_swinblocks: int = 1, num_emaps: int = 2,
                 num_features: int = 160, kernel_size: int = 3,
                 depths: Tuple[int, ...] = (6,),
                 num_heads: Tuple[int, ...] = (8,),
                 window_size: Tuple[int, int, int] = (7, 8, 8),
                 patch_size: Tuple[int, int, int] = (4, 4, 4),
                 act_type: str = "relu", circular_pad: bool = True,
                 drop_path_rate: float = 0.2,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        in_chans = 2 * num_emaps
        chans = num_features
        self.pad = ((2 * num_swinblocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        self.sfe = ConvBlock(in_chans, chans, kernel_size, "none", generator,
                             dtype=dtype)
        self.trunks = nn.ModuleList(
            SwinTransformer3D(chans, chans, patch_size, depths, num_heads,
                              window_size, drop_path_rate=drop_path_rate,
                              generator=generator, dtype=dtype)
            for _ in range(num_swinblocks))
        self.convs = nn.ModuleList(
            ConvBlock(chans, chans, kernel_size, act_type, generator,
                      dtype=dtype)
            for _ in range(num_swinblocks))
        self.dfe_conv = ConvBlock(chans, chans, kernel_size, act_type,
                                  generator, dtype=dtype)
        self.out_conv = ConvBlock(chans, in_chans, kernel_size, act_type,
                                  generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = x.shape[1]
        with span("trunk.sfe"):
            h = torch.cat([x.real, x.imag], dim=1)      # [N, 2E, T, Y, X]
            h = circular_pad_time(h, self.pad)
            h = self.sfe(h)
        dfe_in = h
        for trunk, conv in zip(self.trunks, self.convs):
            blk_in = h
            with span("trunk.swin"):
                h = trunk(h.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
            with span("trunk.conv"):
                h = conv(h) + blk_in
        with span("trunk.dfe_conv"):
            h = self.dfe_conv(h)
            h = h + dfe_in
            h = dfe_in + h          # the reference's extra skip
        with span("trunk.out_conv"):
            h = crop_time(self.out_conv(h), self.pad)
            return torch.complex(h[:, :e].contiguous(),
                                 h[:, e:].contiguous())
