"""The window-attention kernels' plain PyTorch versions, forward and
backward, against the JAX package's Pallas kernels (`_pallas_attention` and
`_pallas_attention_bwd`, run in interpret mode as tests/test_kernels.py
runs them) in float32 and bfloat16, and its XLA reference
(`_attention_xla`), and the wrappers' CPU route, autograd included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl_swin_gan_tpu.kernels.window_attn as JWA
from dl_swin_gan_tpu.models.swin import compute_shift_mask as jax_shift_mask
from dl_swin_gan_tpu_torch.kernels import window_attn as WA

torch.set_num_threads(1)

# Both sides compute in float32 and differ only in the order of the sums
# (448-term dot products, softmax sums, the p @ v contraction): about 1e-6
# of the output's largest entry. 1e-5 catches any change of formula, such
# as a missing scale, bias or mask row, which moves the output by ~1e-1.
REL_TOL = 1e-5
# bfloat16 q, k, v (and g): both sides widen them to float32, compute in
# float32 and round only the outputs, so the rounded outputs agree but
# where the two float32 values straddle a rounding boundary: there by one
# bf16 ulp. Compared in float32: every element within one ulp of the
# Pallas kernel's (of the larger magnitude of the two) plus 1e-6 of the
# largest element (the float32 sums' own spread, which exceeds a tiny
# element's ulp: measured up to 5e-8), and rel L2 1e-4 over all (measured
# 1e-9 to 6e-5; a kernel that multiplied in bf16 or rounded p first, as
# `_attention_xla` does, is 4e-3 to 5e-3 away).
BF16_REL_L2 = 1e-4
BF16_FLOOR = 1e-6


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = JWA.pl.pallas_call
    monkeypatch.setattr(JWA.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))


def _data(W, H, N, D, nW=None, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((W, H, N, D)).astype(np.float32)
               for _ in range(3))
    bias = (0.5 * rng.standard_normal((H, N, N))).astype(np.float32)
    mask = None
    if nW is not None:
        mask = np.where(rng.rand(nW, N, N) < 0.3, -100.0, 0.0).astype(
            np.float32)
    return q, k, v, bias, mask


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _assert_bf16_close(a, b, what):
    """a and b (bfloat16) within one bf16 ulp (plus BF16_FLOOR of the
    largest) of each other elementwise, and within BF16_REL_L2 over all."""
    a, b = _f32(a), _f32(b)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    floor = BF16_FLOOR * np.abs(b).max()
    assert (np.abs(a - b) <= ulp + floor).all(), what
    assert np.linalg.norm(a - b) <= BF16_REL_L2 * np.linalg.norm(b), what


def _bf16(*arrays):
    """Each array rounded to bfloat16 (None stays None)."""
    return [None if a is None else np.asarray(
        jnp.asarray(a, jnp.bfloat16)) for a in arrays]


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# the real window of 448 tokens at head_dim 20 with few windows and heads,
# with and without a mask, and a mask indexed modulo nW (W = 2 nW)
CASES = {
    "N448-mask": (2, 2, 448, 20, 2),
    "N448-nomask": (2, 2, 448, 20, None),
    "mask-modulo": (6, 2, 64, 8, 3),
}


def _torch_bf16(*arrays):
    """numpy bfloat16 (ml_dtypes) arrays as torch bfloat16 tensors."""
    return [None if a is None else torch.from_numpy(
        a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
        for a in arrays]


@pytest.mark.parametrize("case", [*CASES, *(f"{c}-bf16" for c in CASES)])
def test_plain_matches_pallas_interpret(interpret_mode, case):
    bf16 = case.endswith("-bf16")
    q, k, v, bias, mask = _data(*CASES[case.removesuffix("-bf16")])
    if bf16:   # q, k, v in bfloat16; the bias and mask stay float32
        q, k, v = _bf16(q, k, v)
        ref = JWA._pallas_attention(*_jax(q, k, v, bias, mask))
        out = WA.window_attention_plain(*_torch_bf16(q, k, v),
                                        *_torch(bias, mask))
        assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        _assert_bf16_close(out, ref, case)
        return
    ref = np.asarray(JWA._pallas_attention(*_jax(q, k, v, bias, mask)))
    out = WA.window_attention_plain(*_torch(q, k, v, bias, mask)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    assert _rel(out, ref) <= REL_TOL


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_attention_xla(case):
    q, k, v, bias, mask = _data(*CASES[case], seed=1)
    ref = np.asarray(JWA._attention_xla(*_jax(q, k, v, bias, mask)))
    out = WA.window_attention_plain(*_torch(q, k, v, bias, mask)).numpy()
    assert _rel(out, ref) <= REL_TOL


def test_mask_row_is_window_modulo_nw():
    """Window w takes mask row w % nW: shifting the mask rows by one moves
    the output of every window, and windows w and w + nW agree when their
    q, k, v agree."""
    q, k, v, bias, mask = _data(4, 1, 16, 4, 2, seed=2)
    q[2:], k[2:], v[2:] = q[:2], k[:2], v[:2]
    out = WA.window_attention_plain(*_torch(q, k, v, bias, mask)).numpy()
    np.testing.assert_array_equal(out[2:], out[:2])
    rolled = WA.window_attention_plain(
        *_torch(q, k, v, bias, mask[::-1].copy())).numpy()
    assert np.abs(rolled - out).max() > 1e-2


def test_plain_with_the_full_width_shift_mask():
    """The shifted block of the full-width Swin trunk: a (7, 8, 8) window on
    a 7x48x16 grid gives 12 windows of 448 tokens; one head, D = 20."""
    mask = jax_shift_mask(7, 48, 16, (7, 8, 8), (0, 4, 4))
    q, k, v, bias, _ = _data(12, 1, 448, 20, seed=3)
    ref = np.asarray(JWA._attention_xla(*_jax(q, k, v, bias, mask)))
    out = WA.window_attention_plain(*_torch(q, k, v, bias, mask)).numpy()
    assert _rel(out, ref) <= REL_TOL


def test_wrapper_on_cpu_takes_the_plain_version(monkeypatch):
    q, k, v, bias, mask = _torch(*_data(6, 2, 64, 8, 3))
    before = WA.window_attention.launches
    calls = []
    plain = WA.window_attention_plain
    monkeypatch.setattr(WA, "window_attention_plain",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(WA, "_library", lambda: pytest.fail("built a kernel"))
    out = WA.window_attention(q, k, v, bias, mask)
    assert calls == [1] and WA.window_attention.launches == before
    torch.testing.assert_close(out, plain(q, k, v, bias, mask), rtol=0, atol=0)


def test_wrapper_checks_shapes():
    q, k, v, bias, mask = _torch(*_data(6, 2, 64, 8, 3))
    with pytest.raises(ValueError, match="one shape"):
        WA.window_attention(q, k[:, :1], v, bias, mask)
    with pytest.raises(ValueError, match="bias"):
        WA.window_attention(q, k, v, bias[:1], mask)
    with pytest.raises(ValueError, match="multiple"):
        WA.window_attention(q, k, v, bias, torch.zeros(4, 64, 64))


# ---------------------------------------------------------------- backward

# the JAX test's own tolerance for the backward (tests/test_kernels.py)
BWD_TOL = 1e-4


def _grads(case, seed):
    q, k, v, bias, mask = _data(*CASES[case], seed=seed)
    g = np.random.RandomState(seed + 100).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, bias, mask, g


@pytest.mark.parametrize("case", [*CASES, *(f"{c}-bf16" for c in CASES)])
def test_bwd_plain_matches_pallas_interpret(interpret_mode, case):
    """float32, and bfloat16 q, k, v and g: dq, dk and dv come back in
    bfloat16 (within one ulp, as the forward), dbias in float32 (to the
    float32 limit: both sum the same float32 ds)."""
    bf16 = case.endswith("-bf16")
    q, k, v, bias, mask, g = _grads(case.removesuffix("-bf16"), seed=4)
    if bf16:
        q, k, v, g = _bf16(q, k, v, g)
        ref = JWA._pallas_attention_bwd(*_jax(q, k, v, bias, mask, g))
        qt, kt, vt, gt = _torch_bf16(q, k, v, g)
        out = WA.window_attention_bwd_plain(qt, kt, vt, *_torch(bias, mask),
                                            gt)
        for name, a, b in zip(("dq", "dk", "dv"), out, ref):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            _assert_bf16_close(a, b, f"{case} {name}")
        assert out[3].dtype == torch.float32
        assert _rel(out[3].numpy(), np.asarray(ref[3])) <= BWD_TOL
        return
    ref = JWA._pallas_attention_bwd(*_jax(q, k, v, bias, mask, g))
    out = WA.window_attention_bwd_plain(*_torch(q, k, v, bias, mask, g))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), out, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _rel(a.numpy(), b) <= BWD_TOL, name


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_autograd(case):
    """The written-out backward against torch.autograd through the plain
    forward; the mask gets no gradient."""
    q, k, v, bias, mask, g = _torch(*_grads(case, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    WA.window_attention_plain(*leaves, mask).backward(g)
    out = WA.window_attention_bwd_plain(q, k, v, bias, mask, g)
    for name, a, leaf in zip(("dq", "dk", "dv", "dbias"), out, leaves):
        assert _rel(a.numpy(), leaf.grad.numpy()) <= REL_TOL, name


def test_wrapper_gradients_on_cpu_take_the_plain_backward(monkeypatch):
    """With inputs that require grad, window_attention goes through its
    autograd Function: on the CPU the forward is the plain version, and the
    backward is window_attention_bwd_plain, called once with the cotangent;
    no kernel is built and no launch is counted."""
    q, k, v, bias, mask, g = _torch(*_grads("mask-modulo", seed=6))
    calls = []
    plain_bwd = WA.window_attention_bwd_plain
    monkeypatch.setattr(WA, "window_attention_bwd_plain",
                        lambda *a: calls.append(a[-1]) or plain_bwd(*a))
    monkeypatch.setattr(WA, "_library", lambda: pytest.fail("built a kernel"))
    monkeypatch.setattr(WA, "_bwd_library",
                        lambda: pytest.fail("built a kernel"))
    before = (WA.window_attention.launches, WA.window_attention_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    out = WA.window_attention(*leaves, mask)
    torch.testing.assert_close(out, WA.window_attention_plain(q, k, v, bias,
                                                              mask),
                               rtol=0, atol=0)
    # a cotangent that is not contiguous, as the trunk's transpose gives
    g_t = g.transpose(2, 3).contiguous().transpose(2, 3)
    out.backward(g_t)
    assert len(calls) == 1 and torch.equal(calls[0], g)
    assert (WA.window_attention.launches,
            WA.window_attention_bwd.launches) == before
    for a, leaf in zip(plain_bwd(q, k, v, bias, mask, g), leaves):
        torch.testing.assert_close(leaf.grad, a, rtol=0, atol=0)


def test_bwd_wrapper_checks_shapes():
    q, k, v, bias, mask, g = _torch(*_grads("mask-modulo", seed=7))
    with pytest.raises(ValueError, match="does not match"):
        WA.window_attention_bwd(q, k, v, bias, mask, g[:, :1])
    with pytest.raises(ValueError, match="multiple"):
        WA.window_attention_bwd(q, k, v, bias, torch.zeros(4, 64, 64), g)


def test_bwd_kernel_takes_every_head_dim_the_wrapper_admits():
    """The CUDA backward is built for head_dim 4, 8, ..., 32 (zero-padded to
    a multiple of 8 for the mma); the shared shape check refuses the rest
    before any kernel is built."""
    for d in range(4, 33, 4):
        WA._check_kernel_shape(torch.empty(2, 1, 3, d), "window_attention_bwd")
    for d in (2, 6, 30, 36):
        with pytest.raises(ValueError, match="head_dim"):
            WA._check_kernel_shape(torch.empty(2, 1, 3, d),
                                   "window_attention_bwd")


# ------------------------------------------- the backward kernel's arithmetic
#
# csrc/window_attn_bwd.cu runs every product on the tensor cores with TF32
# operands (mma.sync m16n8k8), split 3xTF32: x = hi + lo with hi = tf32(x),
# lo = tf32(x - hi), and a b = (a_hi b_lo + a_lo b_hi) + a_hi b_hi. Below,
# that arithmetic in plain torch: it must hold the kernel's 1e-4 limit at the
# full-width window, and plain TF32 (a_hi b_hi alone) must not.


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties away
    from zero, 10 mantissa bits (the low 13 of float32's 23 cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, three):
    """a @ b as the kernel's mma computes it: TF32 operands; with `three`
    also their remainders, the two cross terms first, then hi @ hi."""
    ah, bh = _tf32(a), _tf32(b)
    if not three:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _bwd_as_the_kernel(q, k, v, bias, mask, g, three):
    """(dq, dk, dv, dbias) in the kernel's order: s = (q scale) k^T, then
    + (bias + mask); p = exp(s - lse) with the forward's float32 lse;
    delta = rowsum(g o out); ds = p (dp - delta); every product through
    _mm."""
    W, _, _, D = q.shape
    scale = D ** -0.5
    bm = bias[None] if mask is None else bias[None] + mask[:, None]
    n = bm.shape[0]

    def add_bm(s):
        return (s.reshape(W // n, n, *s.shape[1:]) + bm[None]).reshape(s.shape)

    qs = q * scale
    lse = torch.logsumexp(add_bm(qs @ k.transpose(-1, -2)), -1, keepdim=True)
    out = WA.window_attention_plain(q, k, v, bias, mask)
    p = torch.exp(add_bm(_mm(qs, k.transpose(-1, -2), three)) - lse)
    dp = _mm(g, v.transpose(-1, -2), three)
    ds = p * (dp - (g * out).sum(-1, keepdim=True))
    return (_mm(ds, k, three) * scale, _mm(ds.transpose(-1, -2), qs, three),
            _mm(p.transpose(-1, -2), g, three), ds.sum(0))


def test_tf32_rounding_and_split():
    one = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                        1 + 3 * 2.0 ** -11], dtype=torch.float32)
    torch.testing.assert_close(
        _tf32(one), torch.tensor([1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10),
                                  1 + 2.0 ** -9]), rtol=0, atol=0)
    x = torch.from_numpy(np.random.RandomState(9).standard_normal(
        1000).astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
    assert ((hi - x).abs() > x.abs() * 2.0 ** -14).any()


@pytest.fixture(scope="module")
def full_width_bwd():
    """The full-width shifted block's window (N 448, D 20; 12 windows of the
    7x48x16 grid with its shift mask) at 2 heads, and the plain backward."""
    mask = jax_shift_mask(7, 48, 16, (7, 8, 8), (0, 4, 4))
    q, k, v, bias, _ = _data(12, 2, 448, 20, seed=8)
    g = np.random.RandomState(108).standard_normal(q.shape).astype(np.float32)
    tensors = _torch(q, k, v, bias, mask, g)
    return tensors, WA.window_attention_bwd_plain(*tensors)


@pytest.mark.parametrize("three", [True, False], ids=["3xTF32", "TF32"])
def test_bwd_kernel_arithmetic_against_plain(full_width_bwd, three):
    """3xTF32 stays within the kernel's 1e-4 of the plain float32 backward
    on every gradient; plain TF32, the control, misses it on every one."""
    tensors, plain = full_width_bwd
    rels = [_rel(a.numpy(), b.numpy()) for a, b in
            zip(_bwd_as_the_kernel(*tensors, three=three), plain)]
    if three:
        assert max(rels) <= BWD_TOL, rels
    else:
        assert min(rels) > BWD_TOL, rels


# -------------------------------------------- the forward kernel's arithmetic
#
# csrc/window_attn.cu runs both products on the tensor cores in 3xTF32, as
# the backward does, and the softmax online over chunks of 16 keys in
# order. Below, that arithmetic in plain torch (with _mm as above): at the
# full-width window it must hold the kernel's 1e-4 limit on the output and
# on the row log-sum-exp the backward reads, and plain TF32 must not.

FWD_CHUNK = 16   # keys per online-softmax step, the kernel's kChunk


def _exp2_fma(s, m):
    """2^(s log2(e) - m log2(e)) as the kernel takes it: m log2(e) rounded
    to float32, then one rounding of the fused multiply-add."""
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    ml = (m * log2e).double()
    return torch.exp2((s.double() * log2e.double() - ml).float())


def _fwd_as_the_kernel(q, k, v, bias, mask, three):
    """(out, lse) in the kernel's order: for each chunk of keys in turn,
    s = (q scale) k^T through _mm, + bias, then + mask; the running max m;
    p = exp(s - m) as 2^(s log2(e) - m log2(e)); the accumulator rescaled by
    exp(m_old - m), then acc += p [v, 1] through _mm: V's first padding
    column (D = 20 pads to 24) holds ones, so acc's column D is the row sum.
    out = acc / sum, lse = m + log(sum)."""
    qs = q * q.shape[-1] ** -0.5
    return _fwd_in_chunks(q, k, v, bias, mask,
                          lambda kt: _mm(qs, kt, three),
                          lambda p, x: _mm(p, x, three))


def _fwd_in_chunks(q, k, v, bias, mask, scores, product):
    """(out, lse) of the forward kernel's online softmax over chunks of
    keys, as _fwd_as_the_kernel describes, with s = scores(k_chunk^T) and
    acc += product(p, [v, 1]_chunk)."""
    W, _, N, D = q.shape
    n = 1 if mask is None else mask.shape[0]
    v = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    m = torch.full((*q.shape[:3], 1), -float("inf"))
    acc = torch.zeros_like(v)
    for j0 in range(0, N, FWD_CHUNK):
        j = slice(j0, min(j0 + FWD_CHUNK, N))
        s = scores(k[:, :, j].transpose(-1, -2)) + bias[None, :, :, j]
        if mask is not None:
            s = (s.reshape(W // n, n, *s.shape[1:])
                 + mask[None, :, None, :, j]).reshape(s.shape)
        top = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - top) * 1.4426950408889634)
        p = _exp2_fma(s, top)
        acc = acc * alpha + product(p, v[:, :, j])
        m = top
    total = acc[..., D:]
    return acc[..., :D] / total, (m + torch.log(total))[..., 0]


@pytest.fixture(scope="module")
def full_width_fwd():
    """The full-width shifted block's window (N 448, D 20; 12 windows of the
    7x48x16 grid with its shift mask) at 2 heads, the plain forward and the
    log-sum-exp of its scores."""
    mask = jax_shift_mask(7, 48, 16, (7, 8, 8), (0, 4, 4))
    q, k, v, bias, _ = _data(12, 2, 448, 20, seed=10)
    q, k, v, bias, mask = tensors = _torch(q, k, v, bias, mask)
    s = torch.matmul(q * 20 ** -0.5, k.transpose(-1, -2)) + bias
    s = (s[:, None] + mask[:, None, None]).reshape(s.shape)   # W = nW here
    return tensors, WA.window_attention_plain(*tensors), torch.logsumexp(s, -1)


@pytest.mark.parametrize("three", [True, False], ids=["3xTF32", "TF32"])
def test_fwd_kernel_arithmetic_against_plain(full_width_fwd, three):
    """3xTF32 stays within the kernel's 1e-4 of the plain float32 forward on
    the output and on lse; plain TF32, the control, misses it on both."""
    tensors, plain, plain_lse = full_width_fwd
    out, lse = _fwd_as_the_kernel(*tensors, three=three)
    rels = [_rel(out.numpy(), plain.numpy()),
            _rel(lse.numpy(), plain_lse.numpy())]
    if three:
        assert max(rels) <= BWD_TOL, rels
    else:
        assert min(rels) > BWD_TOL, rels


# ---------------------------------------------- the bf16 kernels' arithmetic
#
# With bfloat16 q, k, v and g, both kernels run every product on the tensor
# cores with bf16 operands (mma.sync m16n8k16, float32 accumulators). A
# product of two bf16 values is exact in float32, so q k^T and g v^T are
# taken as they are, the scale applied to s afterwards; where one operand is
# float32 (p, ds), it is split into hi = bf16(x) and lo = bf16(x - hi), and
# the product is lo b + hi b. Below, that arithmetic in plain torch at the
# full-width window: within the kernels' 1e-4 of the plain float32 versions
# on the same bf16 inputs, before any output rounds; rounding p or ds to
# bf16 once, the control, misses it.


def _bf16_round(x):
    return x.to(torch.bfloat16).float()


def _mm_bf16(a, b, two):
    """a @ b as the bf16 kernels take it, a float32 and b holding bf16
    values: a split into two bf16 terms, the small one first, or (the
    control) rounded to bf16 once."""
    hi = _bf16_round(a)
    if not two:
        return hi @ b
    return _bf16_round(a - hi) @ b + hi @ b


def _bwd_as_the_bf16_kernel(q, k, v, bias, mask, g, two):
    """(dq, dk, dv, dbias) in the bf16 backward's order: s = (q k^T) scale,
    exact, then + (bias + mask); p = exp(s - lse) with the forward's float32
    lse; dp = g v^T, exact; delta = rowsum(g o out); ds = p (dp - delta);
    dq = ds k scale, dk = ds^T q scale, dv = p^T g through _mm_bf16."""
    W, _, _, D = q.shape
    scale = D ** -0.5
    bm = bias[None] if mask is None else bias[None] + mask[:, None]
    n = bm.shape[0]

    def add_bm(s):
        return (s.reshape(W // n, n, *s.shape[1:]) + bm[None]).reshape(s.shape)

    s = add_bm((q @ k.transpose(-1, -2)) * scale)
    lse = torch.logsumexp(add_bm((q * scale) @ k.transpose(-1, -2)), -1,
                          keepdim=True)
    out = WA.window_attention_plain(q, k, v, bias, mask)
    p = torch.exp(s - lse)
    ds = p * (g @ v.transpose(-1, -2) - (g * out).sum(-1, keepdim=True))
    return (_mm_bf16(ds, k, two) * scale,
            _mm_bf16(ds.transpose(-1, -2), q, two) * scale,
            _mm_bf16(p.transpose(-1, -2), g, two), ds.sum(0))


@pytest.fixture(scope="module")
def full_width_bf16():
    """The full-width shifted block's window (N 448, D 20; 12 windows of the
    7x48x16 grid with its shift mask) at 2 heads, q, k, v and g rounded to
    bf16 and held in float32; the plain float32 forward, the log-sum-exp of
    its scores and the plain float32 backward on them."""
    mask = jax_shift_mask(7, 48, 16, (7, 8, 8), (0, 4, 4))
    q, k, v, bias, _ = _data(12, 2, 448, 20, seed=11)
    g = np.random.RandomState(111).standard_normal(q.shape).astype(np.float32)
    q, k, v, g = (_bf16_round(t) for t in _torch(q, k, v, g))
    bias, mask = _torch(bias, mask)
    s = torch.matmul(q * 20 ** -0.5, k.transpose(-1, -2)) + bias
    s = (s[:, None] + mask[:, None, None]).reshape(s.shape)   # W = nW here
    return ((q, k, v, bias, mask, g),
            WA.window_attention_plain(q, k, v, bias, mask),
            torch.logsumexp(s, -1),
            WA.window_attention_bwd_plain(q, k, v, bias, mask, g))


@pytest.mark.parametrize("two", [True, False], ids=["two-term", "one-term"])
def test_bf16_fwd_kernel_arithmetic_against_plain(full_width_bf16, two):
    """Exact bf16 q k^T and two-term p v stay within the kernel's 1e-4 of
    the plain float32 forward on the output and on lse; p rounded to bf16
    once, the control, misses it on the output."""
    (q, k, v, bias, mask, _), plain, plain_lse, _ = full_width_bf16
    scale = q.shape[-1] ** -0.5
    out, lse = _fwd_in_chunks(q, k, v, bias, mask,
                              lambda kt: (q @ kt) * scale,
                              lambda p, x: _mm_bf16(p, x, two))
    rels = [_rel(out.numpy(), plain.numpy()),
            _rel(lse.numpy(), plain_lse.numpy())]
    if two:
        assert max(rels) <= BWD_TOL, rels
    else:
        assert rels[0] > BWD_TOL, rels


@pytest.mark.parametrize("two", [True, False], ids=["two-term", "one-term"])
def test_bf16_bwd_kernel_arithmetic_against_plain(full_width_bf16, two):
    """Exact bf16 s and dp with two-term p and ds stay within the kernel's
    1e-4 of the plain float32 backward on dq, dk, dv and dbias; p and ds
    rounded to bf16 once, the control, miss it on dq, dk and dv (dbias sums
    the float32 ds either way)."""
    tensors, _, _, plain = full_width_bf16
    rels = [_rel(a.numpy(), b.numpy()) for a, b in
            zip(_bwd_as_the_bf16_kernel(*tensors, two=two), plain)]
    if two:
        assert max(rels) <= BWD_TOL, rels
    else:
        assert min(rels[:3]) > BWD_TOL, rels
