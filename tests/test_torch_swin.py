"""The torch port's Swin denoiser against the JAX package: the numpy helpers
bit for bit, the modules on weights converted by `flax_to_torch`, and the
whole unrolled-Swin solver through the Reconstructor."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dl_swin_gan_tpu.models.swin as J
from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.infer.reconstruct import Reconstructor as JaxReconstructor
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu.solvers import build_solver as jax_build_solver
from dl_swin_gan_tpu_torch import convert
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch, init_params
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer import Reconstructor, ResampleTransform
from dl_swin_gan_tpu_torch.infer.reconstruct import batched
from dl_swin_gan_tpu_torch.models import build_denoiser
from dl_swin_gan_tpu_torch.models import swin as S
from dl_swin_gan_tpu_torch.utils.headline import swin_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# float32 on both sides, sums in other orders (LayerNorm statistics, GEMMs,
# convs): ~5e-7 of the largest output entry; 1e-5 catches a wrong weight,
# index or skip, which moves the output by 1e-2 or more
REL_TOL = 1e-5


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _noisy(tree, rng):
    """A flax param tree with its LayerNorm scales, biases and bias tables
    moved off their init (ones, zeros, +-0.04), so a mapping that mixes
    them up shows."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _noisy(leaf, rng)
            continue
        leaf = np.asarray(leaf)
        if name in ("scale", "bias", "relative_position_bias_table"):
            sigma = 0.1 if name == "scale" else 0.3
            leaf = leaf + sigma * rng.standard_normal(leaf.shape).astype(
                np.float32)
        out[name] = leaf
    return out


def _flax(module, x, seed=0):
    """(noisy flax params, flax output) of `module` on x."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), x)["params"]
    params = _noisy(jax.tree_util.tree_map(np.asarray, params),
                    np.random.RandomState(seed))
    return params, np.asarray(jax.jit(module.apply)({"params": params}, x))


def _load(module, state, prefix):
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in state.items()})
    return module.eval()


# ---------------------------------------------------------------- helpers

SHIFT_CASES = [  # (Dp, Hp, Wp, ws, ss)
    (4, 12, 12, (2, 4, 4), (1, 2, 2)),
    (7, 48, 16, (7, 8, 8), (0, 4, 4)),      # the full-width shifted block
    (4, 16, 16, (4, 8, 8), (0, 4, 4)),
    (6, 6, 9, (3, 3, 3), (1, 1, 1)),
]


@pytest.mark.parametrize("case", SHIFT_CASES)
def test_compute_shift_mask_bit_exact(case):
    ours = S.compute_shift_mask(*case)
    ref = J.compute_shift_mask(*case)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("ws", [(7, 8, 8), (2, 4, 4), (1, 3, 5), (4, 8, 8)])
def test_relative_position_index_bit_exact(ws):
    np.testing.assert_array_equal(S._relative_position_index(ws),
                                  J._relative_position_index(ws))


@pytest.mark.parametrize("x_size,ws,ss", [
    ((7, 45, 16), (7, 8, 8), (0, 4, 4)),     # the full-width trunk
    ((3, 10, 10), (7, 8, 8), (3, 4, 4)),
    ((2, 6, 6), (4, 8, 8), (2, 4, 4)),
    ((5, 9, 8), (4, 8, 8), None),
])
def test_get_window_size_matches(x_size, ws, ss):
    assert S.get_window_size(x_size, ws, ss) == J.get_window_size(
        x_size, ws, ss)


@pytest.mark.parametrize("ws", [(2, 4, 4), (7, 8, 8), (1, 2, 3)])
def test_window_partition_reverse_bit_exact(ws):
    rng = np.random.RandomState(0)
    B, C = 2, 3
    D, H, W = ws[0] * 2, ws[1] * 3, ws[2]
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    ref = np.asarray(J.window_partition(jax.numpy.asarray(x), ws))
    wins = S.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(wins.numpy(), ref)
    back = S.window_reverse(wins, ws, B, D, H, W)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        J.window_reverse(jax.numpy.asarray(ref), ws, B, D, H, W)))
    np.testing.assert_array_equal(back.numpy(), x)


# ---------------------------------------------------------------- modules

BLOCK_CASES = {
    # pad D 3 -> 4 and H, W 10 -> 12, shift on every axis
    "pad-shift": ((1, 3, 10, 10, 16), 2, (2, 4, 4), (1, 2, 2)),
    # every axis shrinks the window: shift off, index sliced [:72, :72]
    "shrunk": ((2, 2, 6, 6, 16), 4, (4, 8, 8), (2, 4, 4)),
    # as at full width: time shrinks, space pads and shifts (the quirk and
    # the mask together)
    "full-width-like": ((1, 3, 12, 10, 16), 8, (7, 8, 8), (3, 4, 4)),
}


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_swin_block_matches_flax(case):
    shape, heads, ws, ss = BLOCK_CASES[case]
    x = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    jblock = J.SwinBlock3D(dim=shape[-1], num_heads=heads, window_size=ws,
                           shift_size=ss)
    params, ref = _flax(jblock, x)
    block = _load(S.SwinBlock3D(shape[-1], heads, ws, ss),
                  convert._swin_block(params, "b"), "b")
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    assert _rel(out, ref) <= REL_TOL


TRANSFORMER_CASES = {
    # one stage; the input pads to patch multiples and the transposed conv's
    # output is cropped back (centred)
    "flat-crop": ((1, 6, 18, 14, 8), dict(depths=(2,), num_heads=(2,),
                                           window_size=(2, 2, 2))),
    # two stages: PatchMerging pads an odd width, PatchExpand crops back
    "two-stage": ((1, 4, 16, 12, 8), dict(depths=(2, 2), num_heads=(2, 4),
                                           window_size=(2, 2, 2))),
}


@pytest.mark.parametrize("case", TRANSFORMER_CASES)
def test_swin_transformer_matches_flax(case):
    shape, kw = TRANSFORMER_CASES[case]
    x = np.random.RandomState(2).standard_normal(shape).astype(np.float32)
    params, ref = _flax(J.SwinTransformer3D(in_chans=shape[-1],
                                            embed_dim=8, **kw), x, seed=1)
    net = _load(S.SwinTransformer3D(in_chans=shape[-1], embed_dim=8, **kw),
                convert._swin_transformer(params, "t"), "t")
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == shape
    assert _rel(out, ref) <= REL_TOL


@pytest.mark.parametrize("circular_pad", [True, False])
def test_swinnet_matches_flax(circular_pad):
    rng = np.random.RandomState(3)
    shape = (2, 2, 8, 40, 40)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    params, ref = _flax(J.SwinNet3D(num_features=16,
                                    circular_pad=circular_pad), x, seed=2)
    net = _load(S.SwinNet3D(num_features=16, circular_pad=circular_pad),
                flax_to_torch({"SwinNet3D_0": params}), "nets.0")
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.dtype == np.complex64
    assert _rel(out, ref) <= REL_TOL


# ---------------------------------------------------------------- the solver

T, Y, X, C, E = 8, 40, 40, 4, 2     # 8 frames: the sliding-window init takes 5
ACCEL = 12


def _toy(cfg):
    """configs/config_swin.yaml narrowed to 16 features and 2 unrolls."""
    cfg.defrost()
    cfg.MODEL.PARAMETERS.NUM_FEATURES = 16
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 2
    return cfg


def test_swin_solver_matches_jax_reconstructor():
    """The toy Swin solver on a slice whose windows shrink in time (16
    padded frames -> 4 patches) and pad and shift in space (10 -> 16),
    through both Reconstructors, weights carried by flax_to_torch."""
    jcfg = _toy(jax_load_cfg(str(REPO / "configs/config_swin.yaml")))
    cfg = _toy(load_cfg(str(REPO / "configs/config_swin.yaml")))
    examples = [ResampleTransform(ACCEL, cfg)(
        *make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=s)[:2])
        for s in (0, 1)]
    batch = next(batched(examples, 2))

    model = jax_build_solver(jcfg, lambda: jax_build_denoiser(jcfg))
    b = {k: batch[k][:1] for k in batch}
    params = jax.jit(lambda *a: model.init(
        jax.random.PRNGKey(0), *a[:3], x0=a[3])["params"])(
        b["kspace"], b["maps"], b["mask"], b["init_image"])
    params = _noisy(jax.tree_util.tree_map(np.asarray, params),
                    np.random.RandomState(4))
    ref = JaxReconstructor(jcfg, params)(batch)
    out = Reconstructor(cfg, flax_to_torch(params), device="cpu")(batch)
    assert out.shape == ref.shape == (2, E, T, Y, X)
    assert np.isfinite(out).all()
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-4


def test_swin_cfg_matches_config_swin_yaml():
    """Every field the reconstruction path reads."""
    ours, ref = swin_cfg(), load_cfg(str(REPO / "configs/config_swin.yaml"))
    fields = [
        "MODEL.MODEL_TYPE", "MODEL.META_ARCHITECTURE",
        *(f"MODEL.PARAMETERS.{k}" for k in (
            "NUM_UNROLLS", "NUM_RESBLOCKS", "NUM_SWINBLOCKS", "NUM_FEATURES",
            "NUM_EMAPS", "SHARE_WEIGHTS", "FIX_STEP_SIZE", "SLWIN_INIT",
            "GRAD_CHECKPOINT")),
        *(f"MODEL.PARAMETERS.CONV_BLOCK.{k}" for k in (
            "ACTIVATION", "NORM", "CIRCULAR_PAD", "COMPLEX", "KERNEL_SIZE",
            "DTYPE", "SEPARABLE")),
        *(f"AUG_TRAIN.UNDERSAMPLE.{k}" for k in (
            "NAME", "ACCELERATIONS", "PARTIAL_KX", "PARTIAL_KY")),
        "AUG_TRAIN.CROP_READOUT", "SEED", "OUTPUT_DIR",
    ]

    def get(cfg, path):
        for key in path.split("."):
            cfg = cfg[key]
        return cfg

    for field in fields:
        assert get(ours, field) == get(ref, field), field


def test_build_denoiser_builds_swinnet():
    net = build_denoiser(_toy(swin_cfg()))
    assert isinstance(net, S.SwinNet3D)
    block = net.trunks[0].layers[0].blocks[1]
    assert len(net.trunks) == 1 and len(net.trunks[0].layers[0].blocks) == 6
    assert block.window_size == (7, 8, 8) and block.shift_size == (3, 4, 4)
    assert block.attn.num_heads == 8


@pytest.mark.parametrize("change,match", [
    (("MODEL.PARAMETERS.CONV_BLOCK.COMPLEX", True), "real/imag"),
])
def test_swin_unsupported_options_raise(change, match):
    cfg = _toy(swin_cfg())
    cfg.merge_from_list(list(change))
    with pytest.raises(NotImplementedError, match=match):
        build_denoiser(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_denoiser_passes_the_dtype_to_every_swin_layer(dtype):
    """CONV_BLOCK.DTYPE reaches the ConvBlocks, the trunk's patch convs and
    every block's attention and MLP linears; the parameters stay float32
    (a bfloat16 Swin raised before its kernels were ported)."""
    cfg = _toy(swin_cfg())
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = dtype
    net = build_denoiser(cfg)
    want = getattr(torch, dtype)
    block = net.trunks[0].layers[0].blocks[3]
    assert {net.sfe.conv.dtype, net.convs[0].conv.dtype,
            net.dfe_conv.conv.dtype, net.out_conv.conv.dtype,
            net.trunks[0].dtype, block.attn.qkv.dtype, block.attn.proj.dtype,
            block.mlp.fc1.dtype, block.mlp.fc2.dtype} == {want}
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_init_params_seeded_swin():
    cfg = _toy(swin_cfg())
    a, b = init_params(cfg, 0), init_params(cfg, 0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    table = a["nets.0.trunks.0.layers.0.blocks.0.attn.relative_position_bias_table"]
    assert table.shape == (13 * 15 * 15, 8) and table.abs().max() <= 0.04
    jcfg = _toy(jax_load_cfg(str(REPO / "configs/config_swin.yaml")))
    params = jax.eval_shape(
        jax_build_solver(jcfg, lambda: jax_build_denoiser(jcfg)).init,
        jax.random.PRNGKey(0), *(np.zeros(s, d) for s, d in (
            ((1, C, T, Y, X), np.complex64), ((1, E, C, 1, Y, X), np.complex64),
            ((1, 1, T, Y, X), np.float32))))["params"]
    ref = flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), params))
    assert {k: tuple(v.shape) for k, v in ref.items()} == {
        k: tuple(v.shape) for k, v in a.items()}


def test_flax_to_torch_rejects_unknown_swin_keys():
    zeros = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_torch({"SwinNet3D_0": {"SwinTransformer3D_0": {
            "BasicLayer_0": {"SwinBlock3D_0": {"Dense_9": {"kernel": zeros}}}}}})
    with pytest.raises(KeyError):
        flax_to_torch({"SwinNet3D_0": {"SwinTransformer3D_0": {
            "patch_embed": {"kernel": zeros}}}})


def test_drop_path_draws_from_its_generator():
    x = torch.ones(64, 3)
    assert S.DropPath(0.5).eval()(x) is x
    draws = [S.DropPath(0.5, torch.Generator().manual_seed(7)).train()(x)
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1])
    kept = draws[0][:, 0] != 0
    assert 0 < kept.sum() < 64 and torch.all(draws[0][kept] == 2.0)
    with pytest.raises(RuntimeError, match="generator"):
        S.DropPath(0.5).train()(x)
