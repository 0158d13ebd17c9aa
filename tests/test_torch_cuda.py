"""The torch port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and nvcc; skipped without them. The card's machine has
no JAX, so run these without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import init_params
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer import Reconstructor, ResampleTransform
from dl_swin_gan_tpu_torch.infer.reconstruct import batched
from dl_swin_gan_tpu_torch.kernels import llr_normal as LN
from dl_swin_gan_tpu_torch.kernels import sense_normal as SN
from dl_swin_gan_tpu_torch.kernels import window_attn as WA
from dl_swin_gan_tpu_torch.models.swin import compute_shift_mask
from dl_swin_gan_tpu_torch.ops import sense
from dl_swin_gan_tpu_torch.ops.llr import BlockOp
from dl_swin_gan_tpu_torch.train import DSLRTrainer, Trainer

pytestmark = pytest.mark.cuda

# fp32 FMA in another order than cuBLAS; TF32 anywhere would show as ~1e-3
REL_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _c64(rng, dev, *shape):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.complex64)).to(dev)


def _inputs(dev, B, E, C, T, Y, X, seed=0, rows=False):
    """Random images and maps; weights sampled elementwise, or (rows=True)
    on whole k-space rows as a Cartesian mask samples them, with partial
    rows and, where there are several frames, the last one left empty; or
    (rows an int) on exactly min(rows, Y) partial rows of each frame, all Y
    for rows=-1."""
    rng = np.random.RandomState(seed)
    x = _c64(rng, dev, B, E, T, Y, X)
    maps = _c64(rng, dev, B, E, C, Y, X)
    if isinstance(rows, bool) and rows:
        w = (rng.rand(B, T, Y, 1) < 0.1) & (rng.rand(B, T, Y, X) < 0.75)
        if B * T > 1:
            w[-1, -1] = False
    elif isinstance(rows, bool):
        w = rng.rand(B, T, Y, X) < 0.4
    else:
        count = Y if rows < 0 else min(rows, Y)
        w = rng.rand(B, T, Y, X) < 0.75
        for frame in w.reshape(B * T, Y, X):
            frame[np.arange(Y), rng.randint(0, X, Y)] = True
            frame[rng.permutation(Y)[count:]] = False
    return x, maps, torch.from_numpy(w.astype(np.float32)).to(dev)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# sampled rows per frame: the kernel runs its passes on chunks of 16
@pytest.mark.parametrize("rows", [False, True, 16, 17, 33, -1],
                         ids=["elements", "rows", "R16", "R17", "R33", "Rall"])
@pytest.mark.parametrize("shape", [
    (1, 2, 8, 20, 180, 64),     # the headline slice
    (3, 1, 1, 2, 12, 10),
    (2, 2, 3, 3, 33, 7),        # ragged against warps and rows
    (1, 3, 2, 2, 7, 100),       # wider than tall
    (1, 2, 4, 1, 119, 120),     # near the largest frame the kernel takes
    # few rows and a wide readout: chunk planes of 8, 8, 8, 4, 2 and 1 rows
    (1, 1, 2, 1, 33, 433),
    (1, 1, 2, 2, 16, 800),
    (1, 2, 1, 1, 8, 900),
    (1, 1, 2, 1, 4, 2400),
    (1, 1, 1, 1, 3, 4000),
    (1, 1, 1, 1, 1, 9000),
])
def test_kernel_matches_plain(dev, shape, rows):
    x, maps, w = _inputs(dev, *shape, rows=rows)
    before = SN.sense_normal.launches
    out = SN.sense_normal(x, maps, w)
    torch.cuda.synchronize()
    assert SN.sense_normal.launches == before + 1
    assert _rel(out, SN.sense_normal_plain(x, maps, w)) <= REL_TOL


def test_kernel_rejects_what_it_cannot_take(dev):
    x, maps, w = _inputs(dev, 1, 2, 2, 2, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        SN.sense_normal(x.transpose(3, 4), maps.transpose(3, 4),
                        w.transpose(2, 3))
    with pytest.raises(TypeError):
        SN.sense_normal(x, maps, w.double())
    big = _inputs(dev, 1, 1, 1, 1, 256, 128)
    with pytest.raises(ValueError, match="shared memory"):
        SN.sense_normal(*big)


@pytest.mark.parametrize("rows", [15, 17, 33, -1],
                         ids=["R15", "R17", "R33", "Rall"])
@pytest.mark.parametrize("frame", [(180, 64), (119, 120)])
def test_kernel_repeat_calls_bitwise_equal(dev, frame, rows):
    """No atomics: the coil sum and the chunks' sums run in a fixed order,
    so ten calls in a row give the same bits."""
    x, maps, w = _inputs(dev, 1, 2, 8, 4, *frame, seed=3, rows=rows)
    out = SN.sense_normal(x, maps, w)
    for _ in range(9):
        again = SN.sense_normal(x, maps, w)
        torch.cuda.synchronize()
        assert torch.equal(out, again)


def test_coil_pass_fits_two_blocks_per_sm(dev):
    """At the headline frame (180x64) the coil pass of both kernels runs two
    blocks per SM: 160 blocks of a slice in one wave on 132 SMs."""
    assert SN.blocks_per_sm(180, 64) >= 2
    assert SN.blocks_per_sm(180, 64, LN._library()) >= 2
    assert SN.blocks_per_sm(119, 120) >= 1


def test_normal_gradient_on_card_matches_cpu(dev):
    x, maps, w = _inputs(dev, 1, 2, 3, 2, 16, 12, seed=1)
    maps6, mask = maps.unsqueeze(3), w.unsqueeze(1)
    grads = []
    for d in (dev, torch.device("cpu")):
        v = x.detach().to(d, copy=True).requires_grad_(True)
        (sense.sense_normal(v, maps6.to(d), mask.to(d)).abs() ** 2).sum().backward()
        grads.append(v.grad.cpu())
    assert _rel(grads[0], grads[1]) <= REL_TOL


def test_reconstructor_on_card_matches_cpu(dev):
    cfg = get_cfg()
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS, p.NUM_RESBLOCKS, p.NUM_FEATURES = 2, 1, 8
    p.FIX_STEP_SIZE, p.SLWIN_INIT, p.CONV_BLOCK.COMPLEX = True, True, False
    examples = [ResampleTransform(12, cfg)(
        *make_cine_example(T=8, Y=48, X=16, C=4, E=2, seed=s)[:2])
        for s in (0, 1)]
    batch = next(batched(examples, 2))
    params = init_params(cfg, 0)
    before = SN.sense_normal.launches
    gpu = Reconstructor(cfg, params)(batch)
    assert SN.sense_normal.launches == before + 2
    cpu = Reconstructor(cfg, params, device="cpu")(batch)
    assert np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu) <= REL_TOL


def _attn_inputs(dev, W, H, N, D, nW=None, seed=0):
    """Random q, k, v, a bias well above the init's +-0.04, and, where nW
    is given, the shift mask of a (7, 8, 8) window on a 7x48x16
    grid (nW = 12) or a random 0/-100 mask of nW rows."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((W, H, N, D)).astype(
        np.float32)).to(dev) for _ in range(3))
    bias = torch.from_numpy(
        0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).to(dev)
    mask = None
    if nW == 12 and N == 448:
        mask = torch.from_numpy(compute_shift_mask(
            7, 48, 16, (7, 8, 8), (0, 4, 4))).to(dev)
    elif nW is not None:
        mask = torch.from_numpy(np.where(rng.rand(nW, N, N) < 0.3, -100.0,
                                         0.0).astype(np.float32)).to(dev)
    return q, k, v, bias, mask


@pytest.mark.parametrize("shape", [
    (12, 8, 448, 20, 12),       # the full-width Swin block, batch 1, shifted
    (48, 8, 448, 20, None),     # batch 4, unshifted
    (6, 3, 100, 8, 3),          # ragged against the query and key tiles
    (4, 2, 40, 32, None),       # the widest head_dim, fewer keys than a tile
    (2, 1, 3, 4, 1),            # a tile with nearly every row past N
    # every head_dim the wrapper takes: each pads differently against the
    # mma's k = 8
    *((4, 2, 100, d, 2) for d in (4, 8, 12, 16, 20, 24, 28, 32)),
    # one short of, equal to and one past the 128-row query tile (4 warps of
    # two 16-row groups; at 129 the second tile's block holds one live row
    # and three warps with none) and the 64-key tile (odd N reads the bias
    # and mask a float at a time)
    (3, 2, 127, 20, 3), (3, 2, 128, 20, None), (3, 2, 129, 20, 1),
    # N ending one row into a warp's group: 97 into warp 3's first, 113 into
    # its second, 145 into the second tile's warp 0's second
    (3, 2, 97, 20, 3), (3, 2, 113, 20, 1), (3, 2, 145, 20, None),
    (3, 2, 111, 20, 3), (3, 2, 112, 20, None),   # one row short of a group
    (3, 2, 63, 20, 3), (3, 2, 64, 20, None), (3, 2, 65, 20, 3),
    (2, 2, 449, 20, 1),         # one past seven key tiles and four row tiles
    (48, 8, 448, 20, 12),       # batch 4 with the full-width shift mask
])
def test_window_attention_matches_plain(dev, shape):
    W, H, N, D, nW = shape
    q, k, v, bias, mask = _attn_inputs(dev, W, H, N, D, nW)
    before = WA.window_attention.launches
    out = WA.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert WA.window_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert _rel(out, WA.window_attention_plain(q, k, v, bias, mask)) <= REL_TOL


@pytest.mark.parametrize("shape", [
    (12, 8, 448, 20, 12),       # the full-width Swin block, batch 1, shifted
    (3, 2, 113, 20, 3),         # ragged rows and keys, odd N
    (3, 2, 129, 20, 1),         # one past the 128-row query tile
    (4, 2, 40, 32, None),       # the widest head_dim
    (2, 1, 3, 4, 1),            # nearly every row and key past N
])
def test_window_attention_lse_matches_plain(dev, shape):
    """The row log-sum-exp the backward reads, against the plain scores'; a
    call without it gives the same output bitwise."""
    q, k, v, bias, mask = _attn_inputs(dev, *shape)
    out, lse, out32 = WA.window_attention_fwd(q, k, v, bias, mask,
                                              with_lse=True)
    assert out32 is out
    torch.testing.assert_close(
        lse, torch.logsumexp(_scores(q, k, bias, mask), -1), rtol=1e-5,
        atol=1e-5)
    again, none, none32 = WA.window_attention_fwd(q, k, v, bias, mask,
                                                  with_lse=False)
    assert none is None and none32 is None and torch.equal(out, again)


def test_window_attention_rejects_what_it_cannot_take(dev):
    q, k, v, bias, mask = _attn_inputs(dev, 6, 2, 64, 8, 3)
    with pytest.raises(TypeError):
        WA.window_attention(q.double(), k.double(), v.double(), bias.double())
    with pytest.raises(ValueError, match="contiguous"):
        WA.window_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v, bias, mask)
    with pytest.raises(ValueError, match="out .* and lse"):
        WA.window_attention_bwd(q, k, v, bias, mask, q)
    q6, k6, v6, bias6, _ = _attn_inputs(dev, 2, 1, 16, 6)
    with pytest.raises(ValueError, match="head_dim"):
        WA.window_attention(q6, k6, v6, bias6)
    with pytest.raises(ValueError, match="multiple"):   # 6 windows, 4 rows
        WA.window_attention(q, k, v, bias, torch.zeros(4, 64, 64, device=dev))


def test_swin_reconstructor_on_card_matches_cpu(dev):
    """A narrow Swin solver (32 features, 8 heads of head_dim 4) on a slice
    whose windows shrink in time and shift and pad in space, on the card
    against the CPU path (8 frames: the sliding-window init takes 5)."""
    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "SWIN"
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS, p.NUM_SWINBLOCKS, p.NUM_FEATURES = 2, 1, 32
    p.FIX_STEP_SIZE, p.SLWIN_INIT, p.CONV_BLOCK.COMPLEX = True, True, False
    examples = [ResampleTransform(12, cfg)(
        *make_cine_example(T=8, Y=40, X=40, C=4, E=2, seed=s)[:2])
        for s in (0, 1)]
    batch = next(batched(examples, 2))
    params = init_params(cfg, 0)
    before = WA.window_attention.launches
    gpu = Reconstructor(cfg, params)(batch)
    assert WA.window_attention.launches == before + 6 * 2
    cpu = Reconstructor(cfg, params, device="cpu")(batch)
    assert np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu) <= REL_TOL


def test_sense_normal_resolves_conj_and_neg_views(dev):
    """The kernel reads raw memory: a view with the conj or neg bit set must
    give what its resolved values give."""
    x, maps, w = _inputs(dev, 1, 2, 3, 2, 16, 12, seed=2)
    ref = SN.sense_normal(x.conj().resolve_conj(), maps.conj().resolve_conj(),
                          w)
    out = SN.sense_normal(x.conj(), maps.conj(), w)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    neg = SN.sense_normal(torch._neg_view(x), maps, w)
    torch.testing.assert_close(neg, SN.sense_normal(-x, maps, w), rtol=0,
                               atol=0)
    assert _rel(ref, SN.sense_normal(x, maps, w)) > 1e-2  # conj matters


def test_window_attention_resolves_neg_views(dev):
    q, k, v, bias, mask = _attn_inputs(dev, 6, 2, 64, 8, 3)
    out = WA.window_attention(torch._neg_view(q), k, v, bias, mask)
    torch.testing.assert_close(
        out, WA.window_attention(-q, k, v, bias, mask), rtol=0, atol=0)
    fwd, lse, _ = WA.window_attention_fwd(q, k, v, bias, mask, with_lse=True)
    g = torch.randn_like(q)
    a = WA.window_attention_bwd(q, k, v, bias, mask, torch._neg_view(g),
                                fwd, lse)
    b = WA.window_attention_bwd(q, k, v, bias, mask, -g, fwd, lse)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _bwd_case(dev, shape, seed=0):
    W, H, N, D, nW = shape
    q, k, v, bias, mask = _attn_inputs(dev, W, H, N, D, nW, seed=seed)
    g = torch.from_numpy(np.random.RandomState(seed + 9).standard_normal(
        q.shape).astype(np.float32)).to(dev)
    out, lse, _ = WA.window_attention_fwd(q, k, v, bias, mask, with_lse=True)
    return q, k, v, bias, mask, g, out, lse


@pytest.mark.parametrize("shape", [
    (12, 8, 448, 20, 12),       # the full-width Swin block, batch 1, shifted
    (48, 8, 448, 20, None),     # batch 4, unshifted
    (6, 3, 100, 8, 3),          # ragged against the 64-row and 64-key tiles
    (4, 2, 40, 32, None),       # the widest head_dim
    (2, 1, 3, 4, 1),            # fewer keys and rows than a tile
    # every head_dim the wrapper takes: each pads differently against the
    # mma's k = 8
    *((4, 2, 100, d, 2) for d in (4, 8, 12, 16, 20, 24, 28, 32)),
    (3, 2, 63, 20, 3),          # one key and row short of a tile
    (3, 2, 65, 20, None),       # one past a tile
    (2, 2, 449, 20, 1),         # one past seven tiles
    (48, 8, 448, 20, 12),       # batch 4 with the full-width shift mask
])
def test_window_attention_bwd_matches_plain(dev, shape):
    q, k, v, bias, mask, g, out, lse = _bwd_case(dev, shape)
    torch.testing.assert_close(
        lse, torch.logsumexp(_scores(q, k, bias, mask), -1), rtol=1e-5,
        atol=1e-5)
    before = WA.window_attention_bwd.launches
    grads = WA.window_attention_bwd(q, k, v, bias, mask, g, out, lse)
    torch.cuda.synchronize()
    assert WA.window_attention_bwd.launches == before + 1
    plain = WA.window_attention_bwd_plain(q, k, v, bias, mask, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, plain):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel(a, b) <= REL_TOL, name
    again = WA.window_attention_bwd(q, k, v, bias, mask, g, out, lse)
    for a, b in zip(grads, again):      # no atomics: bitwise reproducible
        assert torch.equal(a, b)


def _scores(q, k, bias, mask):
    s = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2)) + bias
    if mask is not None:
        W, nW = q.shape[0], mask.shape[0]
        s = (s.reshape(W // nW, nW, *s.shape[1:]) + mask[None, :, None]
             ).reshape(s.shape)
    return s


def test_window_attention_autograd_on_card_matches_cpu(dev):
    q, k, v, bias, mask = _attn_inputs(dev, 6, 2, 64, 8, 3)
    g = torch.randn_like(q)
    grads = []
    for d in (dev, torch.device("cpu")):
        leaves = [t.detach().to(d).clone().requires_grad_(True)
                  for t in (q, k, v, bias)]
        fwd = WA.window_attention.launches
        bwd = WA.window_attention_bwd.launches
        WA.window_attention(*leaves, mask.to(d)).backward(g.to(d))
        if d.type == "cuda":
            assert (WA.window_attention.launches - fwd,
                    WA.window_attention_bwd.launches - bwd) == (1, 1)
        grads.append([leaf.grad.cpu() for leaf in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= REL_TOL


# bfloat16 q, k, v (and g): the kernels widen them to float32 and round
# only their outputs, as the plain versions do; their float32 values differ
# by the float32 limit above, so a rounded element may go the other way:
# one bf16 ulp (of the larger magnitude) plus REL_TOL of the largest, and
# rel L2 5e-4 over all (a kernel that multiplied in bf16 or rounded p
# first is 4e-3 away)
BF16_REL_L2 = 5e-4


def _assert_bf16_close(a, b, what):
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(
        mag > 0, mag, torch.ones_like(mag)))) - 7)
    floor = REL_TOL * b.abs().max()
    assert ((a - b).abs() <= ulp + floor).all(), what
    assert ((a - b).norm() / b.norm()).item() <= BF16_REL_L2, what


@pytest.mark.parametrize("shape", [
    (12, 8, 448, 20, 12),       # the full-width Swin block, batch 1, shifted
    (48, 8, 448, 20, None),     # batch 4, unshifted
    (10, 4, 384, 24, None),     # SwinDiff's window shrunk in time, D = 24
    (10, 4, 384, 24, 5),
    (3, 2, 113, 20, 3),         # ragged rows and keys: 40-byte bf16 rows
    (3, 2, 65, 20, None),       # one past a tile, N * D * 2 not a multiple
                                # of 16 bytes
    (4, 2, 100, 28, 2),
    (2, 1, 3, 4, 1),            # nearly every row and key past N
])
def test_window_attention_bf16_matches_plain(dev, shape):
    """The bf16 forward and backward kernels against their plain versions:
    out and dq, dk, dv in bf16, lse and dbias float32; out32 is out before
    its rounding, and what the backward reads."""
    q, k, v, bias, mask = _attn_inputs(dev, *shape)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    g = torch.from_numpy(np.random.RandomState(9).standard_normal(
        tuple(q.shape)).astype(np.float32)).to(dev).bfloat16()
    before = (WA.window_attention.launches, WA.window_attention_bwd.launches)
    out, lse, out32 = WA.window_attention_fwd(q, k, v, bias, mask)
    grads = WA.window_attention_bwd(q, k, v, bias, mask, g, out32, lse)
    torch.cuda.synchronize()
    assert (WA.window_attention.launches, WA.window_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16 and out32.dtype == torch.float32
    assert torch.equal(out, out32.bfloat16())
    _assert_bf16_close(out, WA.window_attention_plain(q, k, v, bias, mask),
                       "out")
    wide = [t.float() for t in (q, k, v)]
    assert _rel(out32, WA.window_attention_plain(*wide, bias, mask)) <= \
        REL_TOL
    torch.testing.assert_close(
        lse, torch.logsumexp(_scores(*wide[:2], bias, mask), -1), rtol=1e-5,
        atol=1e-5)
    plain = WA.window_attention_bwd_plain(q, k, v, bias, mask, g)
    for name, a, b in zip(("dq", "dk", "dv"), grads, plain):
        assert a.dtype == torch.bfloat16, name
        _assert_bf16_close(a, b, name)
    assert grads[3].dtype == torch.float32
    assert _rel(grads[3], plain[3]) <= REL_TOL
    again = WA.window_attention_bwd(q, k, v, bias, mask, g, out32, lse)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_ragged_keys_with_large_bias(dev, dtype):
    """Keys past N take no part in the backward: with N ragged, a bias of
    100 and a mask of -100 at key N - 1, exp(s + bias - lse) at the keys
    past N (s = 0, the bias clamped to column N - 1, no mask there) would
    overflow, and inf times their zero rows of k would put NaN into dq."""
    q, k, v, bias, _ = _attn_inputs(dev, 3, 2, 113, 20)
    bias[:, :, -1] = 100.0
    mask = torch.zeros((3, 113, 113), device=dev)
    mask[:, :, -1] = -100.0
    q, k, v = (t.to(dtype) for t in (q, k, v))
    g = torch.from_numpy(np.random.RandomState(9).standard_normal(
        tuple(q.shape)).astype(np.float32)).to(dev).to(dtype)
    _, lse, out32 = WA.window_attention_fwd(q, k, v, bias, mask)
    grads = WA.window_attention_bwd(q, k, v, bias, mask, g, out32, lse)
    plain = WA.window_attention_bwd_plain(q, k, v, bias, mask, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, plain):
        assert torch.isfinite(a).all(), name
        if a.dtype == torch.bfloat16:
            _assert_bf16_close(a, b, name)
        else:
            assert _rel(a, b) <= REL_TOL, name


def test_window_attention_bf16_backward_keeps_no_ds_scratch(dev):
    """The bf16 backward recomputes ds where it uses it: one call at the
    full-width Swin block (batch 1, shifted) allocates less beyond its
    inputs than one [W, H, N, N] float32 buffer, where the float32 backward
    allocates that scratch on top of its outputs."""
    q, k, v, bias, mask = _attn_inputs(dev, 12, 8, 448, 20, 12)
    g = torch.randn_like(q)
    scratch = 4 * 12 * 8 * 448 * 448
    extra = {}
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd, gd = (t.to(dtype) for t in (q, k, v, g))
        _, lse, out32 = WA.window_attention_fwd(qd, kd, vd, bias, mask)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = WA.window_attention_bwd(qd, kd, vd, bias, mask, gd, out32,
                                        lse)
        torch.cuda.synchronize()
        extra[dtype] = torch.cuda.max_memory_allocated() - base
        del grads
    assert extra[torch.bfloat16] < scratch < extra[torch.float32], extra


def test_window_attention_bf16_autograd_and_refusals(dev):
    """Through autograd the bf16 kernels give what they give called
    directly; a mix of dtypes, or a bf16 out handed to the backward,
    raises."""
    q, k, v, bias, mask = _attn_inputs(dev, 6, 2, 64, 8, 3)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    g = torch.randn(q.shape, device=dev).bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    WA.window_attention(*leaves, mask).backward(g)
    out, lse, out32 = WA.window_attention_fwd(q, k, v, bias, mask)
    direct = WA.window_attention_bwd(q, k, v, bias, mask, g, out32, lse)
    for leaf, d in zip(leaves, direct):
        assert leaf.grad.dtype == d.dtype and torch.equal(leaf.grad, d)
    with pytest.raises(TypeError):
        WA.window_attention(q, k.float(), v, bias, mask)
    with pytest.raises(TypeError):
        WA.window_attention(q, k, v, bias.bfloat16(), mask)
    with pytest.raises(TypeError):
        WA.window_attention_bwd(q, k, v, bias, mask, g, out, lse)


def test_swin_train_step_on_card_matches_cpu(dev):
    """One toy Swin train step (2 unrolls, remat, stochastic depth on, the
    same dropout seed) on the card against the CPU: the loss and the
    gradients."""
    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "SWIN"
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS, p.NUM_SWINBLOCKS, p.NUM_FEATURES = 2, 1, 32
    p.FIX_STEP_SIZE, p.SLWIN_INIT, p.GRAD_CHECKPOINT = True, True, True
    p.CONV_BLOCK.COMPLEX = False
    cfg.AUG_TRAIN.CROP_READOUT = 32
    k, m, t = make_cine_example(T=8, Y=40, X=40, C=4, E=2, seed=0)
    ex = CinePreprocess(cfg, use_seed=True)(k, m, t, "card_case")
    batch = {key: np.asarray(val)[None] for key, val in ex.items()}
    params = init_params(cfg, 0)
    results = []
    for d in ("cuda", "cpu"):
        trainer = Trainer(cfg, device=d)
        state = trainer.init_state(state_dict=params)
        counts = (WA.window_attention.launches,
                  WA.window_attention_bwd.launches, SN.sense_normal.launches)
        loss = float(trainer.train_step(state, batch)["Train/complex_l1"])
        if d == "cuda":
            assert (WA.window_attention.launches - counts[0],
                    WA.window_attention_bwd.launches - counts[1],
                    SN.sense_normal.launches - counts[2]) == (24, 12, 3)
        results.append((loss, torch.cat([
            q.grad.flatten().cpu() for q in state.model.parameters()
            if q.grad is not None])))
    (lg, gg), (lc, gc) = results
    assert abs(lg - lc) / abs(lc) <= REL_TOL
    assert (gg - gc).norm() / gc.norm() <= 1e-3


# ---------------------------------------------------------------- block-LLR normal

def _llr_inputs(dev, S, E, C, T, Y, X, b, seed=0):
    """Blocks of S systems, maps, and a k-space weight that samples whole
    rows (with partial rows), as the DSLR training masks do."""
    rng = np.random.RandomState(seed)
    op = BlockOp(b, (1, E, T, Y, X), device=dev)
    blk = _c64(rng, dev, S, op.num_blocks, E * b * b, T)
    maps = _c64(rng, dev, E, C, Y, X)
    w = (rng.rand(T, Y, 1) < 0.1) & (rng.rand(T, Y, X) < 0.75)
    return op, blk, maps, torch.from_numpy(w.astype(np.float32)).to(dev)


def _llr_plain(op, blk, maps, w2, d_side):
    py, px, dinv, _ = LN.geometry(op, blk.device)
    return LN.mats_to_blocks(LN.llr_normal_plain(
        LN.blocks_to_mats(blk, op), maps, w2, py, px, dinv, d_side), op)


@pytest.mark.parametrize("d_side", ["pre", "post"])
@pytest.mark.parametrize("shape", [
    (1, 2, 8, 20, 180, 64, 16),     # the DSLR training point
    (2, 2, 8, 20, 180, 64, 16),     # its jacobi pair
    (1, 1, 2, 4, 18, 12, 4),        # the CPU tests' toy geometry
    (2, 2, 3, 3, 37, 21, 8),        # odd sizes, ragged tiles
])
def test_llr_normal_matches_plain(dev, shape, d_side):
    op, blk, maps, w2 = _llr_inputs(dev, *shape)
    before = dict(LN.llr_normal.launches)
    out = LN.llr_normal(blk, maps, w2, op, d_side)
    again = LN.llr_normal(blk, maps, w2, op, d_side)
    torch.cuda.synchronize()
    assert LN.llr_normal.launches[d_side] == before[d_side] + 2
    assert torch.equal(out, again)           # no atomics: bitwise equal
    assert _rel(out, _llr_plain(op, blk, maps, w2, d_side)) <= REL_TOL


def test_llr_normal_rejects_what_it_cannot_take(dev):
    op, blk, maps, w2 = _llr_inputs(dev, 1, 1, 2, 2, 18, 12, 4)
    with pytest.raises(ValueError, match="contiguous"):
        LN.llr_normal(blk.transpose(1, 2).contiguous().transpose(1, 2),
                      maps, w2, op)
    with pytest.raises(TypeError):
        LN.llr_normal(blk, maps, w2.double(), op)
    with pytest.raises(ValueError, match="block-LLR"):
        LN.make_fused_block_normal(op, maps[None, :, :, None].repeat(
            1, 1, 1, 2, 1, 1), None)


def test_llr_normal_resolves_conj_and_neg_views(dev):
    op, blk, maps, w2 = _llr_inputs(dev, 1, 2, 2, 3, 18, 12, 4, seed=2)
    want = LN.llr_normal(blk.conj().resolve_conj(), maps, w2, op)
    torch.testing.assert_close(LN.llr_normal(blk.conj(), maps, w2, op), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(
        LN.llr_normal(torch._neg_view(blk), maps, w2, op, "post"),
        LN.llr_normal(-blk, maps, w2, op, "post"), rtol=0, atol=0)
    assert _rel(want, LN.llr_normal(blk, maps, w2, op)) > 1e-2


def test_llr_autograd_on_card_matches_cpu(dev):
    """The gradient through make_fused_block_normal (forward 'pre', backward
    'post' on the cotangent) on the card against the CPU."""
    op, blk, maps, w2 = _llr_inputs(dev, 1, 2, 3, 4, 24, 20, 8, seed=3)
    maps6 = maps[None, :, :, None]
    mask = w2.sqrt()[None, None]
    grads = []
    for d in (dev, torch.device("cpu")):
        o = BlockOp(8, (1, 2, 4, 24, 20), device=d)
        v = blk[0].detach().to(d, copy=True).requires_grad_(True)
        f = LN.make_fused_block_normal(o, maps6.to(d), mask.to(d))
        before = dict(LN.llr_normal.launches)
        (f(v).abs() ** 2).sum().backward()
        if d == dev:
            assert {k: LN.llr_normal.launches[k] - before[k]
                    for k in before} == {"pre": 1, "post": 1}
        grads.append(v.grad.cpu())
    assert _rel(grads[0], grads[1]) <= REL_TOL


def test_dslr_train_step_on_card_matches_cpu(dev):
    """One toy DSLR train step (dslr-cg-v1, 2 unrolls, 3 CG steps) on the
    card against the CPU: the loss, the gradients, and the launches (16
    'pre', 8 'post')."""
    from dl_swin_gan_tpu_torch.utils.headline import dslr_cfg

    cfg = dslr_cfg()
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS, p.NUM_RESBLOCKS, p.NUM_FEATURES = 2, 1, 16
    p.DSLR.BLOCK_SIZE, p.DSLR.NUM_BASIS, p.DSLR.NUM_CG_STEPS = 8, 4, 3
    cfg.AUG_TRAIN.CROP_READOUT = 32
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (4, 5)
    k, m, t = make_cine_example(T=8, Y=40, X=48, C=4, E=2, seed=0)
    ex = CinePreprocess(cfg, use_seed=True, lr_decom=True)(k, m, t, "dslr")
    batch = {key: np.asarray(val)[None] for key, val in ex.items()}
    params = init_params(cfg, 0)
    results = []
    for d in ("cuda", "cpu"):
        trainer = DSLRTrainer(cfg, device=d)
        state = trainer.init_state(state_dict=params)
        before = dict(LN.llr_normal.launches)
        loss = float(trainer.train_step(state, batch)["Train/complex_l1"])
        if d == "cuda":
            assert {k: LN.llr_normal.launches[k] - before[k]
                    for k in before} == {"pre": 16, "post": 8}
        results.append((loss, torch.cat([
            q.grad.flatten().cpu() for q in state.model.parameters()
            if q.grad is not None])))
    (lg, gg), (lc, gc) = results
    assert abs(lg - lc) / abs(lc) <= REL_TOL
    assert (gg - gc).norm() / gc.norm() <= 1e-3
