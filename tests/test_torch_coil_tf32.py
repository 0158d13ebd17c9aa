"""The SENSE coil pass's arithmetic (csrc/coil_normal.cuh) emulated in torch
on the CPU: row chunks of 16 sampled k-space rows, and the four DFT passes
as complex products made of two real products each, on TF32 operands split
3xTF32, as the kernel's `mma.sync.m16n8k8` computes them. The emulation is held against
the plain version in complex128 (1e-4 at the headline frame), against the
Pallas TPU kernel in interpret mode, and with the splits turned off, in
float64, against the plain version to rounding (the chunk bookkeeping).
Plain TF32 is the failing control."""

import numpy as np
import pytest
import torch

import dl_swin_gan_tpu.kernels.sense_normal as JSN
from dl_swin_gan_tpu_torch.infer.transforms import PARITY_SEED
from dl_swin_gan_tpu_torch.kernels import sense_normal as K
from dl_swin_gan_tpu_torch.ops.masks import VDktMaskFunc

torch.set_num_threads(1)

CHUNK = 16            # sampled rows per round of passes 2-5 (the mma's M)
KERNEL_REL_TOL = 1e-4


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties away
    from zero, 10 mantissa bits (the low 13 of float32's 23 cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, mode):
    """a @ b as the kernel's mma computes it: TF32 operands; "3xtf32" also
    their remainders, the two cross terms first, then hi @ hi; "tf32" hi @
    hi alone; "exact" the operands as they are (float64 here)."""
    if mode == "exact":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _cmm(a, b, mode, sa=1, sb=1):
    """op(a) [..., M, K] @ op(b) [..., K, N] as the kernel computes it, op
    conjugating where sa or sb is -1: two real products over b as stored
    (re, im interleaved along its rows), P1 = Re(a) B and P2 = Im(a) B,
    finished per output pair as re = P1.re - sa sb P2.im and
    im = sb P1.im + sa P2.re."""
    bs = torch.view_as_real(b.resolve_conj()).flatten(-2)     # [..., K, 2N]
    p1 = _mm(a.real.contiguous(), bs, mode).unflatten(-1, (-1, 2))
    p2 = _mm(a.imag.contiguous(), bs, mode).unflatten(-1, (-1, 2))
    return torch.complex(p1[..., 0] - sa * sb * p2[..., 1],
                         sb * p1[..., 1] + sa * p2[..., 0])


def _emulate(x, maps, w, mode):
    """The kernel's coil pass and coil sum: per frame, the coil expansion,
    then chunks of up to 16 sampled rows through the y-DFT to those rows,
    the x-DFT, the weight, the inverse x-DFT (conj(fx) by the signs) and
    the inverse y-DFT (conj(fy) likewise), whose chunks add up in order;
    then the sum over coils. float32 (complex64)
    for the TF32 modes, float64 for "exact"."""
    cdt = torch.complex128 if mode == "exact" else torch.complex64
    x, maps = x.to(cdt), maps.to(cdt)
    w = w.to(torch.float64 if mode == "exact" else torch.float32)
    B, E, T, Y, X = x.shape
    fy = K.ortho_dft(Y, torch.device("cpu")).to(cdt)
    fx = K.ortho_dft(X, torch.device("cpu")).to(cdt)
    out = torch.zeros_like(x)
    for b in range(B):
        for t in range(T):
            s = (maps[b] * x[b, :, t, None]).sum(0)                  # [C, Y, X]
            rows = torch.nonzero((w[b, t] != 0).any(1)).flatten()
            coil = torch.zeros_like(s)
            for i0 in range(0, len(rows), CHUNK):
                rc = rows[i0:i0 + CHUNK]
                p = _cmm(fy[rc].expand(len(s), -1, -1), s, mode)     # pass 2
                q = _cmm(p, fx.expand(len(s), -1, -1), mode) * w[b, t, rc]
                p = _cmm(q, fx.expand(len(s), -1, -1), mode, sb=-1)  # pass 4
                coil = coil + _cmm(fy[:, rc].expand(len(s), -1, -1), p,
                                   mode, sa=-1)                      # pass 5
            out[b, :, t] = (maps[b].conj() * coil).sum(1)
    return out


def _dense(x, maps, w):
    """The plain version in the inputs' precision (complex128 here), on the
    kernel's complex64 tables."""
    Y, X = x.shape[-2:]
    fy = K.ortho_dft(Y, torch.device("cpu")).to(torch.complex128)
    fx = K.ortho_dft(X, torch.device("cpu")).to(torch.complex128)
    coils = (maps.unsqueeze(3) * x.unsqueeze(2)).sum(1)
    k = fy @ coils @ fx * w.unsqueeze(1)
    coils = fy.conj() @ k @ fx.conj()
    return (maps.conj().unsqueeze(3) * coils.unsqueeze(1)).sum(2)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _c(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))


@pytest.fixture(scope="module", params=[12, 10], ids=["12x", "10x"])
def headline(request):
    """The headline frame (180x64, C=8, E=2) at T=2, on the 12x parity mask
    (15 sampled rows per frame: one chunk) or a 10x mask (18: two chunks),
    with the plain version in complex128."""
    T, Y, X, C, E = 2, 180, 64, 8, 2
    acc = request.param
    mask = VDktMaskFunc((acc, acc))((1, 1, T, Y, X), PARITY_SEED)[0, 0]
    rows = (mask != 0).any(-1).sum(-1)
    assert (rows == {12: 15, 10: 18}[acc]).all()
    rng = np.random.RandomState(acc)
    x = _c(rng, 1, E, T, Y, X).to(torch.complex64)
    maps = _c(rng, 1, E, C, Y, X).to(torch.complex64)
    w = torch.from_numpy(np.ascontiguousarray(mask[None] ** 2, np.float32))
    return x, maps, w, _dense(x.to(torch.complex128),
                              maps.to(torch.complex128), w.double())


def test_tf32_rounding():
    one = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                        1 + 3 * 2.0 ** -11], dtype=torch.float32)
    torch.testing.assert_close(
        _tf32(one), torch.tensor([1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10),
                                  1 + 2.0 ** -9]), rtol=0, atol=0)


@pytest.mark.parametrize("sa,sb", [(1, 1), (1, -1), (-1, 1), (-1, -1)])
def test_two_real_products_give_the_complex_product(sa, sb):
    """The finish of P1 = Re(a) B and P2 = Im(a) B is op(a) op(b) for each
    sign pair (float64, no rounding)."""
    rng = np.random.RandomState(1)
    a, b = _c(rng, 3, 5), _c(rng, 5, 7)
    want = ((a.conj() if sa < 0 else a) @ (b.conj() if sb < 0 else b))
    torch.testing.assert_close(_cmm(a, b, "exact", sa, sb), want)


@pytest.mark.parametrize("n", [64, 10, 180])
def test_coil_tables_layout(n):
    """The wrapper's split tables: every part TF32 (the low 13 bits clear),
    hi + lo the DFT entry to 2^-22; fy as (re hi, re lo, im hi, im lo) per
    entry; fx rebuilt from its fragment order (lane 4g + t holds rows t,
    t + 4 of column g of each 8 x 8 tile) is ortho_dft(X) as stored,
    zero-padded."""
    cpu = torch.device("cpu")
    fy, fx = K.coil_tables(n, n, cpu)
    dft = K.ortho_dft(n, cpu)
    for part in (fy, fx):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert fy.shape == (n, n, 4)
    for got, want in ((fy[..., 0] + fy[..., 1], dft.real),
                      (fy[..., 2] + fy[..., 3], dft.imag)):
        assert ((got - want).abs() <= 2.0 ** -22 * want.abs()).all()
    stored = torch.view_as_real(dft).reshape(n, 2 * n)
    kt, nt = -(-n // 8), -(-2 * n // 8)
    assert fx.shape == (kt, nt, 8, 4, 2, 2)
    got = torch.zeros(8 * kt, 8 * nt)
    for ks in range(kt):
        for j in range(nt):
            for g in range(8):
                for t in range(4):
                    for i in range(2):
                        got[8 * ks + t + 4 * i, 8 * j + g] = fx[
                            ks, j, g, t, i].sum()
    assert not got[n:].any() and not got[:, 2 * n:].any()
    assert ((got[:n, :2 * n] - stored).abs()
            <= 2.0 ** -22 * stored.abs()).all()


def test_plane_swizzle_is_conflict_free():
    """The shared-memory planes' swizzle (Plane::swz) at 128 floats a row:
    the B operand read as stored (rows k0 + t, column n0 + g), the A operand
    read as (re, im) pairs (rows g, g + 8; columns 2(k0 + t)) and the C
    fragments stored as pairs each touch 32 distinct banks per request (the
    8-byte ones per half-warp)."""
    def swz(r):
        return ((r & 3) << 3) | (r & 4)

    def word(r, k, ld=128):
        return r * ld + (k ^ swz(r))

    for k0 in range(0, 32, 8):
        for n0 in range(0, 128, 8):
            for i in range(2):
                banks = {word(k0 + t + 4 * i, n0 + g) % 32
                         for g in range(8) for t in range(4)}
                assert len(banks) == 32
    for k0 in range(0, 64, 4):
        for r0 in (0, 4, 8, 12):
            banks = {(word(r0 + g, 2 * (k0 + t)) + h) % 32
                     for g in range(4) for t in range(4) for h in range(2)}
            assert len(banks) == 32


def test_emulation_holds_the_limit_at_the_headline_frame(headline):
    x, maps, w, ref = headline
    assert _rel(_emulate(x, maps, w, "3xtf32"), ref) <= KERNEL_REL_TOL / 10


def test_plain_tf32_misses_the_limit(headline):
    """The control: TF32 without the split keeps about three digits."""
    x, maps, w, ref = headline
    assert _rel(_emulate(x, maps, w, "tf32"), ref) > KERNEL_REL_TOL


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = JSN.pl.pallas_call
    monkeypatch.setattr(JSN.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))


def test_emulation_matches_pallas_kernel(interpret_mode):
    """At a toy shape with whole sampled rows (two chunks in one frame, none
    in another), against the TPU kernel run in interpret mode."""
    rng = np.random.RandomState(2)
    B, E, C, T, Y, X = 1, 2, 3, 2, 40, 12
    x = _c(rng, B, E, T, Y, X).numpy().astype(np.complex64)
    maps = _c(rng, B, E, C, Y, X).numpy().astype(np.complex64)
    w = np.zeros((B, T, Y, X), np.float32)
    w[0, 0, rng.permutation(Y)[:20]] = 1.0
    outr, outi = JSN.sense_normal_fused(x.real, x.imag, maps.real, maps.imag,
                                        w)
    ref = np.asarray(outr) + 1j * np.asarray(outi)
    ours = _emulate(torch.from_numpy(x), torch.from_numpy(maps),
                    torch.from_numpy(w), "3xtf32").numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("R", [0, 1, 15, 16, 17, 32, 40])
def test_chunk_bookkeeping(R):
    """With the splits off (float64), chunks of 16 rows give the plain
    version to rounding for every count of sampled rows around the chunk
    edges, all Y = 40 rows included; rows hold partial weights."""
    rng = np.random.RandomState(R)
    B, E, C, T, Y, X = 1, 2, 3, 2, 40, 12
    x = _c(rng, B, E, T, Y, X)
    maps = _c(rng, B, E, C, Y, X)
    w = torch.zeros(B, T, Y, X, dtype=torch.float64)
    for t in range(T):
        rows = torch.from_numpy(rng.permutation(Y)[:R])
        w[0, t, rows] = torch.from_numpy(
            rng.rand(len(rows), X) * (rng.rand(len(rows), X) < 0.7))
        w[0, t, rows, 0] = 1.0
    assert ((w != 0).any(-1).sum(-1) == R).all()
    out = _emulate(x, maps, w, "exact")
    ref = _dense(x, maps, w)
    assert (out.abs().max() == 0) if R == 0 else _rel(out, ref) < 1e-12
