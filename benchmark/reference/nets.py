"""Plain PyTorch denoiser trunks of the reference, read from a state dict.

The RES trunk (3D ResNet of the original `configs/basic/example.yaml`) and
SwinNet3D (video Swin transformer of `configs/config_swin.yaml`), written
from their published structure. The state dict is the one the benchmark
drew (`benchmark/weights.py`); its keys are the program's parameter names,
the only thing the two share. Departures from a textbook network that the
original dl-swin-gan code makes, and this reference follows:

  - RES: the residual of a res block is relu(x), not x (an in-place ReLU
    in the original); the first conv block has no activation; time is
    padded circularly by (2 n_blocks + 2) (k - 1) / 2 frames around the
    trunk; the global residual is the padded input;
  - Swin: the window shrinks to the axis (and its shift goes to 0) on an
    axis not longer than the window; blocks pad to whole windows, roll by
    -shift, mask cross-region pairs with -100, and roll back; stochastic
    depth drops a block's branches per sample at a rate rising linearly
    from 0 to 0.2 over the blocks; the deep-feature input is added
    twice; the patch unembedding is a transposed conv then a centred crop.
    Which samples a train step's stochastic depth keeps is an input: the
    program's own decisions in that step (`RecordedDrops`).

Every convolution, linear layer and attention product goes through
`Precision`, which computes it in float32 (TF32 off), or, for a cell that
states a lower precision and for a control, rounds its operands and output
as that precision does (`CONTROLS`).
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero, as the tensor cores' cvt.rna rounds."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to fp8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), back in float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class _Rounded(torch.autograd.Function):
    """fn(a, b) on operands rounded by `op`, its output rounded by `out`;
    the backward rounds the incoming gradient by `op`, takes the two
    products' gradients at the rounded operands, and rounds them by
    `out`: a product computed in a lower precision, both ways."""

    @staticmethod
    def forward(ctx, a, b, fn, op, out):
        ra, rb = op(a), op(b)
        ctx.save_for_backward(ra, rb)
        ctx.fn, ctx.op, ctx.out = fn, op, out
        return out(fn(ra, rb))

    @staticmethod
    def backward(ctx, g):
        ra, rb = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = ctx.fn(ra, rb)
        ga, gb = torch.autograd.grad(y, (ra, rb), ctx.op(g))
        return ctx.out(ga), ctx.out(gb), None, None, None


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


# precision -> (operand rounding, output rounding) of the trunk's products:
# bfloat16 is the program's bf16 conv (bf16 operands, float32 accumulation,
# a bf16 output; the bias added in float32 after), fp8 the step below it
# (fp8 operands, a bf16 output), tf32 the tensor cores' float32 mode
CONTROLS: Dict[str, Optional[tuple]] = {
    "float32": None, "tf32": (_tf32, _same), "bfloat16": (_bf16, _bf16),
    "fp8": (_fp8, _bf16)}


class Precision:
    """How the trunk's convolutions, linear layers and attention products
    round (a key of CONTROLS); float32 rounds nothing."""

    def __init__(self, trunk: str = "float32"):
        self.rounding = CONTROLS[trunk]

    def _product(self, fn, a, b):
        if self.rounding is None:
            return fn(a, b)
        return _Rounded.apply(a, b, fn, *self.rounding)

    def conv3d(self, x, w, b, **kw):
        y = self._product(lambda u, v: F.conv3d(u, v, **kw), x, w)
        return y + b.reshape(-1, 1, 1, 1)

    def conv_transpose3d(self, x, w, b, **kw):
        y = self._product(lambda u, v: F.conv_transpose3d(u, v, **kw), x, w)
        return y + b.reshape(-1, 1, 1, 1)

    def linear(self, x, w, b=None):
        y = self._product(F.linear, x, w)
        return y if b is None else y + b

    def matmul(self, a, b):
        return self._product(torch.matmul, a, b)


def _to_channels(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.real, x.imag], 1)


def _to_complex(h: torch.Tensor, e: int) -> torch.Tensor:
    return torch.complex(h[:, :e].contiguous(), h[:, e:].contiguous())


def _circular_time(h: torch.Tensor, pad: int) -> torch.Tensor:
    n = h.shape[2]
    idx = torch.arange(-pad, n + pad, device=h.device) % n
    return h.index_select(2, idx)


# -- RES ------------------------------------------------------------------

def res_trunk(x, p: Dict[str, torch.Tensor], prefix: str, n_blocks: int,
              prec: Precision) -> torch.Tensor:
    """The RES denoiser on complex x [N, E, T, Y, X]."""
    def conv(h, name):
        return prec.conv3d(h, p[f"{prefix}{name}.conv.weight"],
                           p[f"{prefix}{name}.conv.bias"], padding=1)

    e = x.shape[1]
    pad = (2 * n_blocks + 2) * (3 - 1) // 2
    h = _circular_time(_to_channels(x), pad)
    resid = h
    h = conv(h, "head")
    for i in range(n_blocks):
        inner = conv(F.relu(conv(F.relu(h), f"blocks.{i}.conv0")),
                     f"blocks.{i}.conv1")
        h = inner + F.relu(h)
    h = conv(F.relu(h), "tail") + resid
    return _to_complex(h[:, :, pad:-pad], e)


# -- Swin -----------------------------------------------------------------

def _window_partition(x, ws):
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2],
                  ws[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), C)


def _window_reverse(w, ws, B, D, H, W):
    x = w.reshape(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1],
                  ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def shift_mask(dims, ws, ss, device) -> torch.Tensor:
    """[nW, N, N]: 0 where query and key lie in one region of the rolled
    grid, -100 where they do not."""
    Dp, Hp, Wp = dims
    img = torch.zeros((1, Dp, Hp, Wp, 1))
    cnt = 0
    spans = [(slice(0, -w), slice(-w, -s or None), slice(-s or n, None))
             for n, w, s in zip(dims, ws, ss)]
    for d in spans[0]:
        for h in spans[1]:
            for w in spans[2]:
                img[:, d, h, w, :] = cnt
                cnt += 1
    m = _window_partition(img, ws)[..., 0]
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(device)


def relative_index(ws) -> torch.Tensor:
    """[N, N] index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in ws],
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.asarray(ws) - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return torch.from_numpy(rel.sum(-1))


def attention(q, k, v, bias, mask, prec: Precision):
    """softmax(q k^T / sqrt(D) + bias + mask) v over [W, H, N, D]; the mask
    [nW, N, N] repeats over the windows."""
    s = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, *s.shape[1:]) + mask[None, :, None]
             ).reshape(s.shape)
    return prec.matmul(torch.softmax(s, -1), v)


def no_drop(h, rate: float, block: str = "", branch: int = 0):
    """Stochastic depth off (serving, and the FLOP count)."""
    return h


class RecordedDrops:
    """Stochastic depth as the program drew it in one train step:
    `keep[module][branch]` is the [B] keep decision of the program's
    DropPath module `<block>.drop_path` on its block's attention (0) or
    MLP (1) branch; `rows` the examples of the batch this forward takes.
    A kept branch is scaled by 1 / (1 - rate), a dropped one is zero."""

    def __init__(self, keep: Dict[str, list], rows: slice):
        self.keep, self.rows = keep, rows

    def __call__(self, h, rate: float, block: str, branch: int):
        if rate == 0.0:
            return h
        module = block + ".drop_path"
        if module not in self.keep:
            raise KeyError(f"no keep decisions recorded for {module}")
        kept = self.keep[module][branch][self.rows].to(h.device)
        kept = kept.reshape((-1,) + (1,) * (h.ndim - 1))
        return torch.where(kept, h / (1.0 - rate),
                           torch.zeros((), dtype=h.dtype, device=h.device))


def _layer_norm(h, p, name):
    return F.layer_norm(h, h.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], 1e-5)


def swin_block(x, p, name, heads, window, shift, rate, prec, drop):
    B, D, H, W, C = x.shape
    ws = [min(w, n) for w, n in zip(window, (D, H, W))]
    ss = [0 if n <= w else s for w, n, s in zip(window, (D, H, W), shift)]
    h = _layer_norm(x, p, name + ".norm1")
    pads = [(-n) % w for n, w in zip((D, H, W), ws)]
    h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dims = h.shape[1:4]
    shifted = any(s > 0 for s in ss)
    mask = None
    if shifted:
        h = torch.roll(h, [-s for s in ss], dims=(1, 2, 3))
        mask = shift_mask(dims, ws, ss, h.device)
    win = _window_partition(h, ws)
    n = win.shape[1]
    hd = C // heads
    qkv = prec.linear(win, p[name + ".attn.qkv.weight"],
                      p[name + ".attn.qkv.bias"])
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    index = relative_index(window)[:n, :n].reshape(-1).to(h.device)
    table = p[name + ".attn.relative_position_bias_table"]
    bias = table[index].reshape(n, n, heads).permute(2, 0, 1)
    out = attention(qkv[0], qkv[1], qkv[2], bias, mask, prec)
    out = prec.linear(out.transpose(1, 2).reshape(-1, n, C),
                      p[name + ".attn.proj.weight"],
                      p[name + ".attn.proj.bias"])
    h = _window_reverse(out, ws, B, *dims)
    if shifted:
        h = torch.roll(h, ss, dims=(1, 2, 3))
    h = h[:, :D, :H, :W]
    x = x + drop(h, rate, name, 0)
    m = _layer_norm(x, p, name + ".norm2")
    m = prec.linear(m, p[name + ".mlp.fc1.weight"], p[name + ".mlp.fc1.bias"])
    m = prec.linear(F.gelu(m), p[name + ".mlp.fc2.weight"],
                    p[name + ".mlp.fc2.bias"])
    return x + drop(m, rate, name, 1)


def swin_transformer(x, p, name, depth, heads, window, patch, prec, drop):
    """One Swin trunk (a single stage), channels-last [B, D, H, W, C]."""
    B, D0, H0, W0, _ = x.shape
    h = F.pad(x, (0, 0, 0, (-W0) % patch[2], 0, (-H0) % patch[1],
                  0, (-D0) % patch[0]))
    h = prec.conv3d(h.permute(0, 4, 1, 2, 3), p[name + ".patch_embed.weight"],
                    p[name + ".patch_embed.bias"], stride=patch)
    h = h.permute(0, 2, 3, 4, 1)
    rates = np.linspace(0, 0.2, depth) if depth > 1 else [0.0]
    half = [w // 2 for w in window]
    for j in range(depth):
        h = swin_block(h, p, f"{name}.layers.0.blocks.{j}", heads, window,
                       (0, 0, 0) if j % 2 == 0 else half, float(rates[j]),
                       prec, drop)
    h = prec.conv_transpose3d(h.permute(0, 4, 1, 2, 3),
                              p[name + ".patch_unembed.weight"],
                              p[name + ".patch_unembed.bias"], stride=patch)
    h = h.permute(0, 2, 3, 4, 1)
    dd, dh, dw = h.shape[1] - D0, h.shape[2] - H0, h.shape[3] - W0
    return h[:, math.ceil(dd / 2):h.shape[1] - dd // 2,
             math.ceil(dh / 2):h.shape[2] - dh // 2,
             math.ceil(dw / 2):h.shape[3] - dw // 2]


def swin_net(x, p, prefix: str, n_swinblocks: int, depth: int, heads: int,
             window, patch, prec: Precision, drop) -> torch.Tensor:
    """SwinNet3D on complex x [N, E, T, Y, X]."""
    def conv(h, name, act=True):
        h = F.relu(h) if act else h
        return prec.conv3d(h, p[f"{prefix}{name}.conv.weight"],
                           p[f"{prefix}{name}.conv.bias"], padding=1)

    e = x.shape[1]
    pad = (2 * n_swinblocks + 2) * (3 - 1) // 2
    h = conv(_circular_time(_to_channels(x), pad), "sfe", act=False)
    dfe_in = h
    for i in range(n_swinblocks):
        blk_in = h
        t = swin_transformer(h.permute(0, 2, 3, 4, 1), p,
                             f"{prefix}trunks.{i}", depth, heads, window,
                             patch, prec, drop)
        h = conv(t.permute(0, 4, 1, 2, 3), f"convs.{i}") + blk_in
    h = conv(h, "dfe_conv") + dfe_in
    h = dfe_in + h
    h = conv(h, "out_conv")
    return _to_complex(h[:, :, pad:-pad], e)
