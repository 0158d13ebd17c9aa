"""ResNet3D and the PGD UnrolledSolver of the torch port against the flax
modules, on weights converted by `flax_to_torch` from a flax init."""

import jax
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu.models.resnet import ResNet3D as JaxResNet3D
from dl_swin_gan_tpu.solvers import build_solver as jax_build_solver
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch, init_params
from dl_swin_gan_tpu_torch.models import build_denoiser
from dl_swin_gan_tpu_torch.models.resnet import ResNet3D
from dl_swin_gan_tpu_torch.solvers import build_model, build_solver

torch.set_num_threads(1)

# both sides compute in float32; the tolerance allows for conv summation order
TOL = dict(atol=1e-4, rtol=1e-4)


def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _tiny(cfg, unrolls=2, share=False):
    p = cfg.MODEL.PARAMETERS
    cfg.MODEL.MODEL_TYPE = "RES"
    p.NUM_UNROLLS = unrolls
    p.NUM_RESBLOCKS = 2
    p.NUM_FEATURES = 8
    p.NUM_EMAPS = 2
    p.SHARE_WEIGHTS = share
    p.FIX_STEP_SIZE = True
    p.CONV_BLOCK.COMPLEX = False
    return cfg


@pytest.mark.parametrize("circular_pad,nres", [(True, 2), (False, 1)])
def test_resnet3d_matches_flax(rng, circular_pad, nres):
    x = _c64(rng, 2, 2, 8, 12, 10)
    jnet = JaxResNet3D(num_resblocks=nres, num_emaps=2, num_features=8,
                       use_complex_layers=False, circular_pad=circular_pad)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), x)["params"]
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, x))

    net = ResNet3D(num_resblocks=nres, num_emaps=2, num_features=8,
                   circular_pad=circular_pad)
    state = flax_to_torch({"ResNet3D_0": params})
    net.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.dtype == np.complex64
    np.testing.assert_allclose(out, ref, **TOL)


def _solver_inputs(rng, B=1, E=2, C=3, T=8, Y=12, X=10):
    y = _c64(rng, B, C, T, Y, X)
    maps = (_c64(rng, B, E, C, 1, Y, X) / np.sqrt(C)).astype(np.complex64)
    mask = (rng.rand(B, 1, T, Y, X) < 0.5).astype(np.float32)
    x0 = _c64(rng, B, E, T, Y, X)
    return y * mask, maps, mask, x0


@pytest.mark.parametrize("share,use_x0", [(False, True), (True, False)])
def test_unrolled_pgd_matches_flax(rng, share, use_x0):
    jcfg = _tiny(jax_get_cfg(), share=share)
    cfg = _tiny(get_cfg(), share=share)
    y, maps, mask, x0 = _solver_inputs(rng)
    x0 = x0 if use_x0 else None

    jmodel = jax_build_solver(jcfg, lambda: jax_build_denoiser(jcfg))
    params = jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(1), *a, x0=x0)
                     )(y, maps, mask)["params"]
    ref = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, x0=x0)
                             )(params, y, maps, mask))

    model = build_solver(cfg)
    model.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        out = model(torch.from_numpy(y), torch.from_numpy(maps),
                    torch.from_numpy(mask),
                    x0=None if x0 is None else torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_unrolled_pgd_complex_res_matches_flax(rng):
    """RES with CONV_BLOCK.COMPLEX (ComplexConv, the x residual) builds and
    matches flax on converted weights."""
    jcfg, cfg = _tiny(jax_get_cfg()), _tiny(get_cfg())
    for c in (jcfg, cfg):
        c.MODEL.PARAMETERS.CONV_BLOCK.COMPLEX = True
    y, maps, mask, x0 = _solver_inputs(rng)
    jmodel = jax_build_solver(jcfg, lambda: jax_build_denoiser(jcfg))
    params = jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(2), *a, x0=x0)
                     )(y, maps, mask)["params"]
    ref = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a,
                                                        x0=x0))(
        params, y, maps, mask))
    model = build_solver(cfg)
    model.load_state_dict(flax_to_torch(params))
    assert model.nets[0].head.conv.kernel_re.shape[0] == int(8 / 1.4142) + 1
    with torch.no_grad():
        out = model(torch.from_numpy(y), torch.from_numpy(maps),
                    torch.from_numpy(mask), x0=torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_flax_to_torch_layout(rng):
    kernel = rng.standard_normal((3, 3, 3, 4, 8)).astype(np.float32)
    tree = {"ResNet3D_0": {"ConvBlock_0": {"Conv_0": {"Conv_0": {
        "kernel": kernel, "bias": np.zeros(8, np.float32)}}}},
        "step_size": np.array([-2.0], np.float32)}
    state = flax_to_torch(tree)
    w = state["nets.0.head.conv.weight"]
    assert w.shape == (8, 4, 3, 3, 3)
    # torch weight[o, i, t, y, x] == flax kernel[t, y, x, i, o]
    assert w[5, 2, 0, 1, 2] == kernel[0, 1, 2, 2, 5]
    assert state["step_size"].tolist() == [-2.0]


def test_flax_to_torch_rejects_complex_conv():
    """A complex conv converts from `ComplexConv_0` with all four leaves
    (tests/test_torch_dslr.py holds it against flax); its leaves under the
    real conv's path, or with one missing, are rejected."""
    leaves = {"kernel_re": np.zeros(1), "kernel_im": np.zeros(1),
              "bias_re": np.zeros(1), "bias_im": np.zeros(1)}
    misplaced = {"ResNet3D_0": {"ConvBlock_0": {"Conv_0": {"Conv_0": leaves}}}}
    with pytest.raises(KeyError):
        flax_to_torch(misplaced)
    partial = {"ResNet3D_0": {"ConvBlock_0": {"ComplexConv_0": {
        k: v for k, v in leaves.items() if k != "bias_im"}}}}
    with pytest.raises(KeyError, match="bias_im"):
        flax_to_torch(partial)


def test_init_params_seeded_torch_default():
    cfg = _tiny(get_cfg())
    a, b, c = init_params(cfg, 0), init_params(cfg, 0), init_params(cfg, 1)
    assert a.keys() == b.keys() == build_solver(cfg).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["nets.0.head.conv.weight"],
                           c["nets.0.head.conv.weight"])
    w = a["nets.0.blocks.0.conv0.conv.weight"]
    bound = 1.0 / np.sqrt(8 * 27)   # U(+-1/sqrt(fan_in)), fan_in = 8*3^3
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert a["step_size"].tolist() == [-2.0]


@pytest.mark.parametrize("change", [
    # every DSLR mode builds since dslr-pgd was ported
    # (tests/test_torch_dslr.py); a Swin trunk on complex layers exists in
    # neither package
    ("MODEL.MODEL_TYPE", "SWIN", "MODEL.PARAMETERS.CONV_BLOCK.COMPLEX",
     "True"),
])
def test_unported_options_raise(change):
    cfg = _tiny(get_cfg())
    cfg.merge_from_list(list(change))
    with pytest.raises(NotImplementedError, match="not (ported|implemented)"):
        build_model(cfg)


@pytest.mark.parametrize("meta", ["dlespirit", "modl"])
def test_bf16_swin_solver_builds(meta):
    """The bf16 Swin trunk under pgd and hqs (it raised before its kernels
    were ported): every unroll's trunk computes in bfloat16, the
    parameters stay float32."""
    cfg = _tiny(get_cfg())
    cfg.merge_from_list(["MODEL.MODEL_TYPE", "SWIN",
                         "MODEL.PARAMETERS.CONV_BLOCK.DTYPE", "bfloat16",
                         "MODEL.META_ARCHITECTURE", meta])
    model = build_model(cfg)
    assert all(net.trunks[0].dtype == torch.bfloat16 for net in model.nets)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("change,dc_mode", [
    (("MODEL.MODEL_TYPE", "DIT", "MODEL.META_ARCHITECTURE", "ddpm_x"), "dc"),
    (("MODEL.MODEL_TYPE", "LATTE", "MODEL.META_ARCHITECTURE", "ddpm_e"),
     "none"),
    (("MODEL.MODEL_TYPE", "SWIN_DIFF", "MODEL.META_ARCHITECTURE", "ddpm_x"),
     "dc"),
    (("MODEL.MODEL_TYPE", "SWIN_DIFF"), "pgd"),
    (("MODEL.MODEL_TYPE", "DIT"), "pgd"),
    (("MODEL.MODEL_TYPE", "LATTE"), "pgd"),
    (("MODEL.MODEL_TYPE", "DIT", "MODEL.META_ARCHITECTURE", "ddpm"), "none"),
    (("MODEL.MODEL_TYPE", "LATTE", "MODEL.META_ARCHITECTURE", "ddpm_x"),
     "dc"),
    (("MODEL.MODEL_TYPE", "DIT", "MODEL.META_ARCHITECTURE", "ddpm_e"),
     "none"),
])
def test_diffusion_options_build(change, dc_mode):
    """The diffusion backbones build, with the DC rule of their config, as
    a DiffusionUnrolled (tests/test_torch_diffusion_models.py holds them
    against the JAX package); the unrolled solver refuses them."""
    from dl_swin_gan_tpu_torch.solvers import DiffusionUnrolled

    cfg = _tiny(get_cfg())
    cfg.merge_from_list(list(change))
    model = build_model(cfg)
    assert isinstance(model, DiffusionUnrolled) and model.dc_mode == dc_mode
    with pytest.raises(ValueError, match="diffusion backbone"):
        build_solver(cfg)


def test_unknown_model_type_is_an_error():
    cfg = _tiny(get_cfg())
    cfg.MODEL.MODEL_TYPE = "NOPE"
    with pytest.raises(ValueError):
        build_denoiser(cfg)
