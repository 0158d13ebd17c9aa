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

`dtype` (CONV_BLOCK.DTYPE) is where the JAX modules take `dtype=`: the
patch embedding, the attention's qkv and proj and its two products, the
MLPs and the final linear compute in it, each as flax's `Dense(dtype=)` or
`Conv(dtype=)` does (`Linear`, `conv_in`): the input, the kernel and the
bias cast to it, the product and the bias add in it. The softmax, the
LayerNorms, the adaLN modulations, the embedders and the residual stream
stay float32: a bfloat16 branch added to the float32 stream promotes to
float32, as in jnp. Parameters stay float32.
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


class Linear(nn.Linear):
    """nn.Linear computed in `dtype` as flax's `Dense(dtype=)` computes it:
    for bfloat16 the input, the weight and the bias are cast to it, the
    product comes out in it (accumulated in float32, rounded once) and the
    bias is added in it. float32 is nn.Linear itself. The parameters stay
    float32."""

    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


def conv_in(layer: nn.Module, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """A patch conv (a Conv2d or Conv3d whose stride is its kernel, no
    padding) or its transpose (a ConvTranspose3d of the same kind) applied
    in `dtype` as flax's `Conv(dtype=)` / `ConvTranspose(dtype=)` apply it:
    the input, kernel and bias cast to `dtype`, the output in it. float32
    is the layer itself. In bfloat16 either is one product over the
    non-overlapping patches, the same sums: torch's CPU conv3d in bfloat16
    is wrong at stride 4 with 16 input channels (rel error about 1 against
    float64, torch 2.13), and it is the transposed conv's input gradient.
    The products are right on every device."""
    if dtype == torch.float32:
        return layer(x)
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    k = w.shape[2:]
    if isinstance(layer, nn.ConvTranspose3d):
        # [N, C, *G] -> [N, *G, O, *k] -> [N, O, *(G k)]
        n, _, *grid = x.shape
        y = (x.to(dtype).movedim(1, -1) @ w.flatten(1)).reshape(
            n, *grid, w.shape[1], *k)
        nd = len(k)
        y = y.permute([0, nd + 1]
                      + [d for i in range(nd) for d in (1 + i, nd + 2 + i)])
        y = y.reshape(n, w.shape[1], *(g * p for g, p in zip(grid, k)))
        return y + b.reshape((-1,) + (1,) * nd)
    return (_patches(x.to(dtype), k) @ w.flatten(1).T + b).movedim(-1, 1)


def _patches(x: torch.Tensor, k) -> torch.Tensor:
    """x [N, C, *S] -> [N, *G, C * prod(k)]: its non-overlapping patches of
    size k (G = S // k; a ragged end is dropped, as VALID drops it), each
    flattened in the order of a conv kernel [C, *k]."""
    n, c, *size = x.shape
    grid = [s // p for s, p in zip(size, k)]
    x = x[(slice(None), slice(None))
          + tuple(slice(0, g * p) for g, p in zip(grid, k))]
    x = x.reshape([n, c] + [v for g, p in zip(grid, k) for v in (g, p)])
    nd = len(k)
    x = x.permute([0, *range(2, 2 + 2 * nd, 2), 1,
                   *range(3, 3 + 2 * nd, 2)])
    return x.reshape(n, *grid, -1)


def linear(in_features: int, out_features: int, bias: bool = True,
           generator: Optional[torch.Generator] = None,
           dtype: torch.dtype = torch.float32) -> Linear:
    """`Linear` in `dtype` with torch's default init, U(+-1/sqrt(fan_in))
    for the weight and the bias, drawn from `generator` (nothing is drawn
    from the global generator)."""
    layer = nn.utils.skip_init(Linear, in_features, out_features, bias=bias)
    layer.dtype = dtype
    bound = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def dense(in_features: int, out_features: int, init: str = "lecun",
          generator: Optional[torch.Generator] = None,
          dtype: torch.dtype = torch.float32) -> Linear:
    """`Linear` in `dtype` initialised as a flax Dense: `init` "lecun"
    (flax's default: a normal of variance 1/fan_in truncated at 2 std),
    "zeros", or "normal" (N(0, 0.02)); the bias zero."""
    layer = nn.utils.skip_init(Linear, in_features, out_features)
    layer.dtype = dtype
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


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU, the tanh form or the exact erf one. float32 is F.gelu; a
    bfloat16 x goes through jax.nn.gelu's formula op by op, each op
    rounding to bfloat16 as jnp's bf16 ops do (its constants rounded to
    bfloat16 first): a single-rounding GELU differs from it in about a
    third of the elements, by one bf16 ulp."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh" if approximate else "none")

    def const(c):
        return torch.tensor(c, dtype=x.dtype, device=x.device)

    if approximate:
        inner = const(math.sqrt(2 / math.pi)) * (
            x + const(0.044715) * (x * x * x))
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    return 0.5 * x * torch.special.erfc(-x * const(math.sqrt(0.5)))


class Mlp(nn.Module):
    """Linear -> GELU -> Linear on the last dim (timm's Mlp). As in the JAX
    package, `approximate=True` is the tanh GELU (DiT, Latte) and
    `approximate=False` the exact erf one (the Swin blocks). `init` "torch"
    is the torch-default Linear (the Swin blocks), "lecun" flax's Dense
    (DiT, Latte). Both linears compute in `dtype`, the GELU runs on the
    first one's output in that dtype, and the output is in it."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 approximate: bool = True,
                 generator: Optional[torch.Generator] = None,
                 init: str = "torch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.approximate = approximate
        if init == "torch":
            self.fc1 = linear(in_features, hidden, generator=generator,
                              dtype=dtype)
            self.fc2 = linear(hidden, out, generator=generator, dtype=dtype)
        else:
            self.fc1 = dense(in_features, hidden, init, generator, dtype)
            self.fc2 = dense(hidden, out, init, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x), self.approximate))


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


def rank_rand(shape, generator: torch.Generator,
              shard=(0, 1)) -> torch.Tensor:
    """U(0, 1) draws of `shape` from `generator` on its device; with
    `shard` (index, count), a data-parallel rank's slice of the draws of
    the global batch (count times the leading dim), so that the ranks
    together draw what one process would."""
    index, count = shard
    b = shape[0]
    draw = torch.rand((b * count,) + tuple(shape[1:]), generator=generator,
                      device=generator.device)
    return draw[index * b:(index + 1) * b]


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
        self.shard = (0, 1)     # set with the generator

    def forward(self, labels: torch.Tensor,
                force_drop_ids: Optional[torch.Tensor] = None):
        if force_drop_ids is not None:
            drop = force_drop_ids == 1
        elif self.training and self.dropout_prob > 0:
            if self.generator is None:
                raise RuntimeError("LabelEmbedder in training mode needs a "
                                   "generator")
            draw = rank_rand(labels.shape, self.generator, self.shard)
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
    qkv_bias=True): two matmuls, the softmax in float32. With a bfloat16
    `dtype` qkv, proj and both products run in it and the probabilities are
    rounded to it before p v, as the JAX module's einsums do."""

    def __init__(self, dim: int, num_heads: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # this rank's heads: all of them, or H / tp under tensor parallelism
        # (parallel/mesh.py apply_tp)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = dense(dim, 3 * dim, "lecun", generator, dtype)
        self.proj = dense(dim, dim, "lecun", generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        h, head = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(B, N, 3, h, head).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * head ** -0.5, qkv[1], qkv[2]
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(),
                             dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(B, N, h * head))


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
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adaLN_modulation = dense(hidden_size, 9 * hidden_size, "zeros")
        self.attn = Attention(hidden_size, num_heads, generator, dtype)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       hidden_size, generator=generator, init="lecun",
                       dtype=dtype)

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
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adaLN_modulation = dense(hidden_size, 6 * hidden_size, "zeros")
        self.attn = Attention(hidden_size, num_heads, generator, dtype)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       hidden_size, generator=generator, init="lecun",
                       dtype=dtype)

    def forward(self, x, c):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(
            self.adaLN_modulation(F.silu(c)), 6, dim=1)
        x = x + g_a[:, None] * self.attn(modulate(_ln(x), sh_a, sc_a))
        return x + g_m[:, None] * self.mlp(modulate(_ln(x), sh_m, sc_m))


class FinalLayer(nn.Module):
    """The zero-initialised output projection, in `dtype`, its output
    float32."""

    def __init__(self, hidden_size: int, patch_vol: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adaLN_modulation = dense(hidden_size, 2 * hidden_size, "zeros")
        self.linear = dense(hidden_size, patch_vol * out_channels, "zeros",
                            dtype=dtype)

    def forward(self, x, c):
        shift, scale = torch.chunk(self.adaLN_modulation(F.silu(c)), 2,
                                   dim=1)
        return self.linear(modulate(_ln(x), shift, scale)).float()


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
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.patch_size = tuple(patch_size)
        self.factorized = factorized
        self.dtype = dtype
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.x_embedder = patch_embedding(in_channels, hidden_size,
                                          self.patch_size, generator)
        self.t_embedder = TimestepEmbedder(hidden_size, generator=generator)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size,
                                        class_dropout_prob, generator)
        block = DiTBlockFactor if factorized else DiTBlock
        self.blocks = nn.ModuleList(
            block(hidden_size, num_heads, mlp_ratio, generator, dtype)
            for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, math.prod(self.patch_size),
                                      self.out_channels, dtype)

    def forward(self, x, t, y):
        N, F_, H, W, _ = x.shape
        p0, p1, p2 = self.patch_size
        pads = ((-F_) % p0, (-H) % p1, (-W) % p2)
        h = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        Gf, Gh, Gw = ((n + p) // q for n, p, q in
                      zip((F_, H, W), pads, self.patch_size))
        h = conv_in(self.x_embedder, h.permute(0, 4, 1, 2, 3),
                    self.dtype)                          # [N, D, Gf, Gh, Gw]
        # the float32 positional add puts the stream back in float32
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
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        in_chans = 2 * num_emaps
        self.learn_sigma = learn_sigma
        self.pad = ((2 * num_blocks + 2) * (kernel_size - 1) // 2
                    if circular_pad else 0)
        self.sfe = ConvBlock(in_chans, hidden_size, kernel_size, "none",
                             generator, dtype=dtype)
        self.dit = DiT(in_channels=hidden_size, hidden_size=hidden_size,
                       patch_size=patch_size, depth=depth,
                       num_heads=num_heads, learn_sigma=learn_sigma,
                       num_classes=num_classes, generator=generator,
                       dtype=dtype)
        self.final_layer = ConvBlock(hidden_size, in_chans, kernel_size,
                                     act_type, generator, dtype=dtype)
        # the reference's learn_sigma path through DiTResNet is broken; as
        # in the JAX package the variance channels get a conv of their own
        self.var_layer = (ConvBlock(hidden_size, in_chans, kernel_size,
                                    act_type, generator, dtype=dtype)
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
