"""Compact-transfer serving of the port (`dl_swin_gan_tpu_torch/infer/
compact.py`) against the JAX package's `infer/compact.py` and against the
port's dense `Reconstructor`: the host codec bit for bit, the device
rebuild and the reconstruction within float32 round-off."""

import jax
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.infer import compact as jc
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch, init_params
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer import Reconstructor, ResampleTransform
from dl_swin_gan_tpu_torch.infer import compact as tc
from dl_swin_gan_tpu_torch.ops import masks as ss

torch.set_num_threads(1)

T, Y, X, C, E = 6, 24, 16, 3, 2
ACCEL = 3.0


def _cfg(cfg):
    p = cfg.MODEL.PARAMETERS
    cfg.MODEL.MODEL_TYPE = "RES"
    p.NUM_UNROLLS = 2
    p.NUM_RESBLOCKS = 1
    p.NUM_FEATURES = 8
    p.NUM_EMAPS = E
    p.FIX_STEP_SIZE = True
    p.SLWIN_INIT = True
    p.CONV_BLOCK.COMPLEX = False
    cfg.OUTPUT_DIR = "runs/test_compact"
    return cfg


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _slice(seed=0):
    kspace, maps, _ = make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=seed)
    return np.asarray(kspace), np.asarray(maps)


def _masked(kspace, accel=ACCEL):
    mask_func = ss.VDktMaskFunc((accel, accel))
    return ss.subsample(kspace[None], mask_func, seed=1000,
                        mode="3D")[0][0].astype(np.complex64)


def _stack(examples):
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _row0_in_a_padded_frame():
    """Masked k-space whose frame 0 acquires rows 0 and 5 and frame 1 rows
    3, 7 and 9: frame 0's third entry is padding, index 0."""
    rng = np.random.RandomState(3)
    ks = np.zeros((C, 2, Y, X), np.complex64)
    for t, rows in ((0, (0, 5)), (1, (3, 7, 9))):
        for r in rows:
            ks[:, t, r] = (rng.randn(C, X) + 1j * rng.randn(C, X))
    return ks


def test_host_codec_bit_for_bit_against_jax():
    """pack_lines (budgeted and not), pad_lines, wire_bytes, the
    CompactTransform and FlatWire.encode at float32 and float16 equal the
    JAX package's on the same inputs."""
    cfg, jcfg = _cfg(get_cfg()), _cfg(jax_get_cfg())
    kspace, maps = _slice()
    masked = _masked(kspace)
    for n_max in (None, 12):
        for a, b in zip(tc.pack_lines(masked, n_max),
                        jc.pack_lines(masked, n_max)):
            _assert_same(a, b)
    ours = tc.CompactTransform(cfg, acceleration=ACCEL)(kspace, maps)
    ref = jc.CompactTransform(jcfg, acceleration=ACCEL)(kspace, maps)
    assert set(ours) == set(ref) == set(tc.WIRE_KEYS)
    for key in tc.WIRE_KEYS:
        _assert_same(ours[key], ref[key])
    n = ours["line_idx"].shape[-1] + 3
    ours_p, ref_p = tc.pad_lines(ours, n), jc.pad_lines(ref, n)
    for key in tc.WIRE_KEYS:
        _assert_same(ours_p[key], ref_p[key])
    assert tc.wire_bytes(ours_p) == jc.wire_bytes(ref_p)
    for dtype in (np.float32, np.float16):
        a = tc.FlatWire(ours_p, dtype)
        b = jc.FlatWire(ref_p, dtype)
        assert a.length == b.length
        _assert_same(a.encode(ours_p), b.encode(ref_p))


def test_unpack_lines_against_jax_with_row_0_in_a_padded_frame():
    """The device scatter against JAX's .at[].add, on a batch of the toy
    slice's first 2 frames packed into 10 lines and of a frame whose
    acquired row 0 shares its index with the frame's padding: both rebuild
    the masked k-space exactly."""
    special = _row0_in_a_padded_frame()
    packed, idx, valid = tc.pack_lines(special)
    assert idx[0, 2] == 0 and valid[0, 2] == 0 and valid[0, 0] == 1
    ex = tc.pad_lines(dict(kspace_lines=packed, line_idx=idx,
                           line_valid=valid), 10)
    masked = _masked(_slice()[0])[:, :2]
    p2, i2, v2 = tc.pack_lines(masked, 10)
    b = _stack([ex, dict(kspace_lines=p2, line_idx=i2, line_valid=v2)])
    ours = tc.unpack_lines(*(torch.from_numpy(b[k]) for k in
                             ("kspace_lines", "line_idx", "line_valid")), Y)
    ref = np.asarray(jc.unpack_lines(b["kspace_lines"], b["line_idx"],
                                     b["line_valid"], Y))
    ours = ours.numpy()
    assert ours.shape == ref.shape == (2, C, 2, Y, X)
    np.testing.assert_array_equal(ours[0], special)
    np.testing.assert_array_equal(ours[1], masked)
    assert _rel_l2(ours, ref) <= 1e-4
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def jax_weights():
    """(JAX cfg, flax params) from the JAX CompactReconstructor's own
    init on the toy slice's packed batch."""
    jcfg = _cfg(jax_get_cfg())
    kspace, maps = _slice()
    ex = jc.CompactTransform(jcfg, acceleration=ACCEL)(kspace, maps)
    rec = jc.CompactReconstructor(jcfg, None, ny=Y)
    params = rec.init_params({k: np.asarray(v)[None] for k, v in ex.items()})
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def test_compact_reconstructor_matches_jax(jax_weights):
    """Two slices at 3x and 5x, padded to one line budget, over the dict
    wire and the float32 flat wire: the port's CompactReconstructor
    within rel L2 1e-4 of the JAX package's with converted weights."""
    jcfg, params = jax_weights
    cfg = _cfg(get_cfg())
    exs = [tc.CompactTransform(cfg, acceleration=a)(*_slice(s))
           for s, a in ((0, 3.0), (1, 5.0))]
    n_max = max(e["line_idx"].shape[-1] for e in exs)
    exs = [tc.pad_lines(e, n_max) for e in exs]
    batch = _stack(exs)
    ref = jc.CompactReconstructor(jcfg, params, ny=Y)(batch)
    ours = tc.CompactReconstructor(cfg, flax_to_torch(params), ny=Y,
                                   device="cpu")(batch)
    assert ours.shape == ref.shape == (2, E, T, Y, X)
    assert ours.dtype == np.complex64 and np.isfinite(ours).all()
    assert _rel_l2(ours, ref) <= 1e-4
    wire = tc.FlatWire(exs[0])
    buf = np.stack([wire.encode(e) for e in exs])
    jwire = jc.FlatWire(exs[0])
    ref_flat = jc.CompactReconstructor(jcfg, params, ny=Y, wire=jwire)(buf)
    ours_flat = tc.CompactReconstructor(cfg, flax_to_torch(params), ny=Y,
                                        wire=wire, device="cpu")(buf)
    assert _rel_l2(ours_flat, ref_flat) <= 1e-4
    np.testing.assert_array_equal(ours_flat, ours)


def test_compact_matches_dense_reconstructor():
    """The compact path against the port's dense Reconstructor fed by
    ResampleTransform, slices of different line counts batched through
    pad_lines, within the JAX package's own tolerance
    (tests/test_compact_transfer.py: rtol 2e-3, atol 2e-4 of the max)."""
    cfg = _cfg(get_cfg())
    params = init_params(cfg, 0)
    dense = Reconstructor(cfg, params, device="cpu")
    exs, refs = [], []
    for seed, accel in ((0, 3.0), (1, 5.0)):
        kspace, maps = _slice(seed)
        ex = ResampleTransform(accel, cfg)(kspace, maps)
        refs.append(dense({k: np.asarray(v)[None] for k, v in ex.items()})[0])
        exs.append(tc.CompactTransform(cfg, acceleration=accel)(kspace, maps))
    assert tc.wire_bytes(exs[0]) < 0.55 * tc.wire_bytes(
        ResampleTransform(ACCEL, cfg)(*_slice()))
    n_max = max(e["line_idx"].shape[-1] for e in exs)
    out = tc.CompactReconstructor(cfg, params, ny=Y, device="cpu")(
        _stack([tc.pad_lines(e, n_max) for e in exs]))
    for i, ref in enumerate(refs):
        np.testing.assert_allclose(out[i], ref, rtol=2e-3,
                                   atol=2e-4 * np.abs(ref).max())


def test_flat_wires_against_the_dict_wire():
    """FlatWire float32 equals the dict wire bit for bit; float16 within
    5e-3 of the largest magnitude (tests/test_compact_transfer.py)."""
    cfg = _cfg(get_cfg())
    ex = tc.CompactTransform(cfg, acceleration=ACCEL)(*_slice())
    rec = tc.CompactReconstructor(cfg, None, ny=Y, device="cpu")
    rec.params = rec.init_params()
    out_dict = rec({k: np.asarray(v)[None] for k, v in ex.items()})
    w32 = tc.FlatWire(ex, np.float32)
    buf = w32.encode(ex)
    assert buf.dtype == np.float32 and buf.ndim == 1
    assert buf.nbytes == tc.wire_bytes(buf)
    out32 = tc.CompactReconstructor(cfg, rec.params, ny=Y, wire=w32,
                                    device="cpu")(buf[None])
    np.testing.assert_array_equal(out32, out_dict)
    w16 = tc.FlatWire(ex, np.float16)
    assert w16.length == w32.length
    out16 = tc.CompactReconstructor(cfg, rec.params, ny=Y, wire=w16,
                                    device="cpu")(w16.encode(ex)[None])
    np.testing.assert_allclose(out16, out_dict, rtol=0,
                               atol=5e-3 * np.abs(out_dict).max())


def test_codec_refusals():
    """The float16 wire refuses line indices above 2048 (float32 takes
    them), and pack_lines a budget below a frame's acquired lines, as the
    JAX package does."""
    ex = dict(kspace_lines=np.zeros((1, 1, 2, 4), np.complex64),
              line_idx=np.array([[100, 3000]], np.int32),
              line_valid=np.ones((1, 2), np.float32),
              maps=np.zeros((1, 1, 4096, 4), np.complex64))
    for codec in (tc, jc):
        with pytest.raises(ValueError, match="2048"):
            codec.FlatWire(ex, np.float16).encode(ex)
        codec.FlatWire(ex, np.float32).encode(ex)
    masked = _masked(_slice()[0])
    for codec in (tc, jc):
        with pytest.raises(ValueError, match="n_max"):
            codec.pack_lines(masked, n_max=1)


def test_needs_cuda_or_explicit_cpu(monkeypatch):
    cfg = _cfg(get_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.CompactReconstructor(cfg, None, ny=Y)
