"""Diffusion Transformer (DiT) for 3D (t, y, x) volumes, and the transformer
pieces the Swin and Latte trunks share.

Counterpart of `models/dit.py` in the JAX package: the sinusoidal
timestep embedding, `TimestepEmbedder`, `LabelEmbedder` with its
classifier-free-guidance dropout, the 3D and 2D sin-cos positional
embeddings (numpy constants), plain multi-head `Attention`, `Mlp`,
`DiTBlockFactor` (adaLN-Zero, 9-way modulation, factorized attention),
`DiTBlock`, the zero-init `FinalLayer`, `DiT` with its unpatchify and
`DiTResNet`, the wrapper the diffusion solvers build. The reference quirks
the JAX package keeps on purpose are kept here too:

  - the second factorized attention reuses the spatial shift and scale
    (with the temporal gate);
  - both factorized attentions share one `Attention` module;
  - unpatchify centre-crops although the patch padding was appended at the
    end;
  - `num_blocks` of `DiTResNet` only sets the circular pad extent.

The transformer runs channels-last [N, F, H, W, C], as the JAX package
does; only the patch-embedding conv and DiTResNet's ConvBlocks see torch's
NCDHW. The attention is two `torch.matmul`s with the softmax in float32,
as the JAX package's two einsums. Weights are initialised as the JAX
modules initialise theirs (flax's lecun-normal Dense, zero adaLN and final
projections, xavier-uniform patch embedding, N(0, 0.02) embedders), drawn
from an explicit generator; `linear` is the seeded torch-default Linear the
Swin blocks use.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dl_swin_gan_tpu_torch.models.layers import (
    ConvBlock, circular_pad_time, crop_time,
)


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


def dense(in_features: int, out_features: int, init: str = "lecun",
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear initialised as a flax Dense: `init` "lecun" (flax's
    default: a normal of variance 1/fan_in truncated at 2 std), "zeros", or
    "normal" (N(0, 0.02)); the bias zero."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features)
    with torch.no_grad():
        layer.bias.zero_()
        if init == "zeros":
            layer.weight.zero_()
        elif init == "normal":
            layer.weight.normal_(0.0, 0.02, generator=generator)
        elif init == "lecun":
            std = math.sqrt(1.0 / in_features) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")
    return layer


class Mlp(nn.Module):
    """Linear -> GELU -> Linear on the last dim (timm's Mlp). As in the JAX
    package, `approximate=True` is the tanh GELU (DiT, Latte) and
    `approximate=False` the exact erf one (the Swin blocks). `init` "torch"
    is the torch-default Linear (the Swin blocks), "lecun" flax's Dense
    (DiT, Latte)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 approximate: bool = True,
                 generator: Optional[torch.Generator] = None,
                 init: str = "torch"):
        super().__init__()
        self.approximate = "tanh" if approximate else "none"
        if init == "torch":
            self.fc1 = linear(in_features, hidden, generator=generator)
            self.fc2 = linear(hidden, out, generator=generator)
        else:
            self.fc1 = dense(in_features, hidden, init, generator)
            self.fc2 = dense(hidden, out, init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


# ---------------------------------------------------------------- embeddings

def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period=10000) -> torch.Tensor:
    """Sinusoidal embeddings [N, dim] of the timesteps t [N], in float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_size: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freq_size = freq_size
        self.fc1 = dense(freq_size, hidden_size, "normal", generator)
        self.fc2 = dense(hidden_size, hidden_size, "normal", generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = timestep_embedding(t, self.freq_size)
        return self.fc2(F.silu(self.fc1(h)))


class LabelEmbedder(nn.Module):
    """Class-label embedding with classifier-free-guidance dropout: in
    training mode each label is replaced by the null class `num_classes`
    with probability `dropout_prob`, drawn from `self.generator` (the
    trainer's dropout generator, `models.swin.set_dropout_generator`), or
    where `force_drop_ids` is 1."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.utils.skip_init(
            nn.Embedding, num_classes + int(dropout_prob > 0), hidden_size)
        with torch.no_grad():
            self.embedding_table.weight.normal_(0.0, 0.02,
                                                generator=generator)
        self.generator = None

    def forward(self, labels: torch.Tensor,
                force_drop_ids: Optional[torch.Tensor] = None):
        if force_drop_ids is not None:
            drop = force_drop_ids == 1
        elif self.training and self.dropout_prob > 0:
            if self.generator is None:
                raise RuntimeError("LabelEmbedder in training mode needs a "
                                   "generator")
            draw = torch.rand(labels.shape, generator=self.generator,
                              device=self.generator.device)
            drop = (draw < self.dropout_prob).to(labels.device)
        else:
            drop = None
        if drop is not None:
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels.long())


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed_3d(dim: int, grid: Tuple[int, int, int],
                 max_grid: Tuple[int, int, int] = (128, 128, 15)
                 ) -> np.ndarray:
    """The reference's PosEmbed lookup, in closed form: its table is built
    on an 'xy'-indexed meshgrid over max_grid and token (f, h, w) takes flat
    index r = w + maxF*h + maxF*maxH*f, which does not invert the table's
    layout. The per-token vectors are scrambled but deterministic, and
    weights trained on them need them exactly; unravelling r over the
    table's (maxH, maxF, maxW) shape gives the three embedded values."""
    F_, H, W = grid
    maxF, maxH, maxW = max_grid
    d = dim // 3
    d_even = d if d % 2 == 0 else d - 1
    ff, hh, ww = np.meshgrid(np.arange(F_), np.arange(H), np.arange(W),
                             indexing="ij")
    r = (ww + maxF * hh + maxF * maxH * ff).reshape(-1)
    pos_t = (r // maxW) % maxF
    pos_w = r // (maxF * maxW)
    pos_h = r % maxW
    emb = np.concatenate([
        _sincos_1d(d_even, pos_t.astype(np.float64)),
        _sincos_1d(d_even, pos_w.astype(np.float64)),
        _sincos_1d(d_even, pos_h.astype(np.float64)),
    ], axis=1)
    if emb.shape[1] < dim:
        emb = np.concatenate(
            [emb, np.zeros((emb.shape[0], dim - emb.shape[1]))], axis=1)
    return emb.astype(np.float32)


def pos_embed_2d(dim: int, grid: Tuple[int, int]) -> np.ndarray:
    """Latte's PosEmbed lookup: the column in the first dim/2, the row in
    the second."""
    H, W = grid
    hh, ww = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    emb = np.concatenate([
        _sincos_1d(dim // 2, ww.astype(np.float64)),
        _sincos_1d(dim // 2, hh.astype(np.float64)),
    ], axis=1)
    return emb.astype(np.float32)


_CONSTANTS = {}


def constant(key: tuple, make, device) -> torch.Tensor:
    """A numpy constant (a positional embedding) on `device`, cached, built
    outside inference mode."""
    full = key + (str(device),)
    out = _CONSTANTS.get(full)
    if out is None:
        with torch.inference_mode(False):
            out = torch.from_numpy(make()).to(device)
        _CONSTANTS[full] = out
    return out


# ---------------------------------------------------------------- attention

class Attention(nn.Module):
    """Multi-head self-attention on [B, N, C] (timm-equivalent,
    qkv_bias=True): two matmuls, the softmax in float32."""

    def __init__(self, dim: int, num_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = dense(dim, 3 * dim, "lecun", generator)
        self.proj = dense(dim, dim, "lecun", generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads
        head = C // h
        qkv = self.qkv(x).reshape(B, N, 3, h, head).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * head ** -0.5, qkv[1], qkv[2]
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(),
                             dim=-1)
        out = torch.matmul(attn, v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias, eps 1e-6 (flax's)."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def factorize(x, grid, flag):
    """grid = (b, f, h, w); tokens [b, f*h*w, d]. flag 0: spatial groups
    [b*f, h*w, d]; flag 1: temporal groups [b*h*w, f, d]."""
    b, f, h, w = grid
    d = x.shape[-1]
    if flag == 0:
        return x.reshape(b * f, h * w, d)
    x = x.reshape(b, f, h, w, d).permute(0, 2, 3, 1, 4)
    return x.reshape(b * h * w, f, d)


def unfactorize(x, grid, flag):
    b, f, h, w = grid
    d = x.shape[-1]
    if flag == 0:
        return x.reshape(b, f * h * w, d)
    x = x.reshape(b, h, w, f, d).permute(0, 3, 1, 2, 4)
    return x.reshape(b, f * h * w, d)


class DiTBlockFactor(nn.Module):
    """adaLN-Zero block with factorized temporal-then-spatial attention,
    the reference's modulation quirk included."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.adaLN_modulation = dense(hidden_size, 9 * hidden_size, "zeros")
        self.attn = Attention(hidden_size, num_heads, generator)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       hidden_size, generator=generator, init="lecun")

    def forward(self, x, c, grid):
        (sh_sp, sc_sp, g_sp, sh_tm, sc_tm, g_tm, sh_mlp, sc_mlp,
         g_mlp) = torch.chunk(self.adaLN_modulation(F.silu(c)), 9, dim=1)
        # first: over the frames of each spatial location (flag 1)
        h = modulate(_ln(x), sh_sp, sc_sp)
        x = g_sp[:, None] * unfactorize(self.attn(factorize(h, grid, 1)),
                                        grid, 1) + x
        # second: over the pixels of each frame (flag 0), with the spatial
        # shift and scale again, as the reference has it
        h = modulate(_ln(x), sh_sp, sc_sp)
        x = g_tm[:, None] * unfactorize(self.attn(factorize(h, grid, 0)),
                                        grid, 0) + x
        h = self.mlp(modulate(_ln(x), sh_mlp, sc_mlp))
        return x + g_mlp[:, None] * h


class DiTBlock(nn.Module):
    """Plain (joint spatiotemporal) adaLN-Zero block; Latte's
    TransformerBlock is the same module."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.adaLN_modulation = dense(hidden_size, 6 * hidden_size, "zeros")
        self.attn = Attention(hidden_size, num_heads, generator)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       hidden_size, generator=generator, init="lecun")

    def forward(self, x, c):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(
            self.adaLN_modulation(F.silu(c)), 6, dim=1)
        x = x + g_a[:, None] * self.attn(modulate(_ln(x), sh_a, sc_a))
        return x + g_m[:, None] * self.mlp(modulate(_ln(x), sh_m, sc_m))


class FinalLayer(nn.Module):
    """The zero-initialised output projection."""

    def __init__(self, hidden_size: int, patch_vol: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = dense(hidden_size, 2 * hidden_size, "zeros")
        self.linear = dense(hidden_size, patch_vol * out_channels, "zeros")

    def forward(self, x, c):
        shift, scale = torch.chunk(self.adaLN_modulation(F.silu(c)), 2,
                                   dim=1)
        return self.linear(modulate(_ln(x), shift, scale))


def patch_embedding(in_channels: int, hidden_size: int, patch,
                    generator: Optional[torch.Generator]) -> nn.Module:
    """The patchify conv (2D or 3D by len(patch)), stride = kernel, its
    kernel xavier-uniform (flax's fans: the kernel volume times the in and
    the out channels), its bias zero."""
    conv = nn.Conv3d if len(patch) == 3 else nn.Conv2d
    layer = nn.utils.skip_init(conv, in_channels, hidden_size, tuple(patch),
                               stride=tuple(patch))
    vol = math.prod(patch)
    bound = math.sqrt(6.0 / (vol * (in_channels + hidden_size)))
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.zero_()
    return layer


def _crop_padding(h: torch.Tensor, sizes, pads, first: int) -> torch.Tensor:
    """Centre-crop the end-appended padding off axes first, first+1, ...
    (the reference's unpatchify quirk)."""
    index = [slice(None)] * h.ndim
    for i, (n, p) in enumerate(zip(sizes, pads)):
        index[first + i] = slice(math.ceil(p / 2), (n + p) - p // 2)
    return h[tuple(index)]


# ---------------------------------------------------------------- DiT top

class DiT(nn.Module):
    """DiT over channels-last [N, F, H, W, C] feature volumes."""

    def __init__(self, in_channels: int = 4, hidden_size: int = 384,
                 patch_size: Tuple[int, int, int] = (2, 4, 4), depth: int = 6,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 num_classes: int = 1, class_dropout_prob: float = 0.1,
                 learn_sigma: bool = False, factorized: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.patch_size = tuple(patch_size)
        self.factorized = factorized
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.x_embedder = patch_embedding(in_channels, hidden_size,
                                          self.patch_size, generator)
        self.t_embedder = TimestepEmbedder(hidden_size, generator=generator)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size,
                                        class_dropout_prob, generator)
        block = DiTBlockFactor if factorized else DiTBlock
        self.blocks = nn.ModuleList(
            block(hidden_size, num_heads, mlp_ratio, generator)
            for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, math.prod(self.patch_size),
                                      self.out_channels)

    def forward(self, x, t, y):
        N, F_, H, W, _ = x.shape
        p0, p1, p2 = self.patch_size
        pads = ((-F_) % p0, (-H) % p1, (-W) % p2)
        h = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        Gf, Gh, Gw = ((n + p) // q for n, p, q in
                      zip((F_, H, W), pads, self.patch_size))
        h = self.x_embedder(h.permute(0, 4, 1, 2, 3))    # [N, D, Gf, Gh, Gw]
        tokens = h.flatten(2).transpose(1, 2)
        tokens = tokens + constant(
            ("pos3d", self.hidden_size, Gf, Gh, Gw),
            lambda: pos_embed_3d(self.hidden_size, (Gf, Gh, Gw)),
            x.device)[None]
        c = self.t_embedder(t) + self.y_embedder(y)
        grid = (N, Gf, Gh, Gw)
        for block in self.blocks:
            tokens = (block(tokens, c, grid) if self.factorized
                      else block(tokens, c))
        tokens = self.final_layer(tokens, c)
        h = tokens.reshape(N, Gf, Gh, Gw, p0, p1, p2, self.out_channels)
        h = h.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(
            N, Gf * p0, Gh * p1, Gw * p2, self.out_channels)
        return _crop_padding(h, (F_, H, W), pads, 1)


def to_complex_solver_layout(h: torch.Tensor, learn_sigma: bool):
    """[N, 2E(*2), T, Y, X] real channels [re, im(, var re, var im)] ->
    complex [N, E(*2), T, Y, X]."""
    parts = torch.chunk(h, 4 if learn_sigma else 2, dim=1)
    comp = [torch.complex(parts[2 * i].contiguous(),
                          parts[2 * i + 1].contiguous())
            for i in range(len(parts) // 2)]
    return torch.cat(comp, dim=1) if learn_sigma else comp[0]


class DiTResNet(nn.Module):
    """SFE conv -> DiT -> final conv on (x + res); complex [N, E, T, Y, X]
    in and out, conditioned on (t, y)."""

    def __init__(self, num_emaps: int = 2, hidden_size: int = 384,
                 depth: int = 6, num_heads: int = 16,
                 patch_size: Tuple[int, int, int] = (2, 4, 4),
                 num_blocks: int = 2, kernel_size: int = 3,
                 act_type: str = "relu", circular_pad: bool = True,
                 learn_sigma: bool = False, num_classes: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_chans = 2 * num_emaps
        self.learn_sigma = learn_sigma
        self.pad = ((2 * num_blocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        self.sfe = ConvBlock(in_chans, hidden_size, kernel_size, "none",
                             generator)
        self.dit = DiT(in_channels=hidden_size, hidden_size=hidden_size,
                       patch_size=patch_size, depth=depth,
                       num_heads=num_heads, learn_sigma=learn_sigma,
                       num_classes=num_classes, generator=generator)
        self.final_layer = ConvBlock(hidden_size, in_chans, kernel_size,
                                     act_type, generator)
        # the reference's learn_sigma path through DiTResNet is broken; as
        # in the JAX package the variance channels get a conv of their own
        self.var_layer = (ConvBlock(hidden_size, in_chans, kernel_size,
                                    act_type, generator)
                          if learn_sigma else None)

    def forward(self, x, t, y):
        h = circular_pad_time(torch.cat([x.real, x.imag], dim=1), self.pad)
        res = self.sfe(h)
        h = self.dit(res.permute(0, 2, 3, 4, 1), t, y).permute(0, 4, 1, 2, 3)
        if self.learn_sigma:
            mean, var = torch.chunk(h, 2, dim=1)
            h = torch.cat([self.final_layer(mean + res),
                           self.var_layer(var)], dim=1)
        else:
            h = self.final_layer(h + res)
        return to_complex_solver_layout(crop_time(h, self.pad),
                                        self.learn_sigma)
