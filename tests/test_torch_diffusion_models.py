"""The port's diffusion backbones (DiT, Latte, SwinDiff) and its diffusion
solver against the JAX package's, on the CPU at toy widths, on weights
converted by `flax_to_torch` from numpy draws shaped by `jax.eval_shape`
of the flax init: each backbone's forward, and the solver in its dc, none,
pgd and hqs modes and with LEARN_SIGMA (shared and per-unroll weights),
rel L2 1e-4 (sums in other orders); the backbones' builds from a config,
the bf16 DiT's and Latte's builds, and remat giving the same gradients as
the plain backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.models import build_denoiser
from dl_swin_gan_tpu_torch.models.dit import DiTResNet, pos_embed_3d
from dl_swin_gan_tpu_torch.models.latte import LatteNet
from dl_swin_gan_tpu_torch.models.swin_diff import SwinDiffNet
from dl_swin_gan_tpu_torch.solvers import DiffusionUnrolled, build_model
from dl_swin_gan_tpu_torch.models.swin import set_dropout_generator
from dl_swin_gan_tpu.models.dit import pos_embed_3d as jax_pos_embed_3d
from tests.test_torch_diffusion import (
    _rel_l2, jax_kwargs, jax_solver_and_params, operands, torch_kwargs,
    torch_solver, toy_cfg,
)
from tests.test_torch_gates import seeded_params

torch.set_num_threads(1)

TOL = 1e-4
ROOTS = {"DIT": "DiTResNet_0", "LATTE": "LatteNet_0",
         "SWIN_DIFF": "SwinDiffNet_0"}
TYPES = {"DIT": DiTResNet, "LATTE": LatteNet, "SWIN_DIFF": SwinDiffNet}


@pytest.mark.parametrize("model_type", ["DIT", "LATTE", "SWIN_DIFF"])
def test_backbone_forward_matches_jax(model_type):
    """One backbone on (x, t, y) with non-zero adaLN, FiLM and final
    layers."""
    jcfg = toy_cfg(jax_get_cfg, model_type)
    x, _, _, t = operands(5)
    y = np.ones((x.shape[0],), np.int32)
    jnet = jax_build_denoiser(jcfg, deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, seeded_params(
        jnet, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), seed=1))
    want = np.asarray(jax.jit(lambda p: jnet.apply({"params": p},
                                                   jnp.asarray(x),
                                                   jnp.asarray(t),
                                                   jnp.asarray(y)))(params))
    net = build_denoiser(toy_cfg(get_cfg, model_type))
    assert isinstance(net, TYPES[model_type])
    state = flax_to_torch({ROOTS[model_type]: params})
    net.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x), torch.from_numpy(t).long(),
                         torch.from_numpy(y).long()).numpy()
    assert got.shape == want.shape == x.shape and np.isfinite(got).all()
    assert _rel_l2(got, want) <= TOL


def test_pos_embed_3d_matches_jax():
    for dim, grid in ((24, (3, 5, 4)), (193, (11, 39, 16))):
        assert np.array_equal(pos_embed_3d(dim, grid),
                              jax_pos_embed_3d(dim, grid))


# (META_ARCHITECTURE, SHARE_WEIGHTS, LEARN_SIGMA, unrolls)
MODES = [("DDPM_X", False, False, 2), ("DDPM_E", False, False, 2),
         ("dlespirit", True, False, 2), ("modl", False, False, 2),
         ("DDPM_E", True, True, 2), ("DDPM_E", False, True, 3)]


@pytest.mark.parametrize("meta,share,learn_sigma,unrolls", MODES, ids=[
    f"{m}-{'shared' if s else 'own'}{'-sigma' if ls else ''}-{u}"
    for m, s, ls, u in MODES])
def test_diffusion_solver_matches_jax(meta, share, learn_sigma, unrolls):
    """DiffusionUnrolled over a toy Latte: dc (x0 the noisy input), none,
    pgd (A then its adjoint), hqs (CG), and the 2x-channel final unroll of
    LEARN_SIGMA."""
    jcfg = toy_cfg(jax_get_cfg, meta=meta, share=share,
                   learn_sigma=learn_sigma, unrolls=unrolls)
    x, maps, mask, t = operands(6)
    jmodel, params = jax_solver_and_params(jcfg, x, maps, mask, seed=2)
    want = np.asarray(jax.jit(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(t),
        **jax_kwargs(maps, mask)))(params))
    model = torch_solver(toy_cfg(get_cfg, meta=meta, share=share,
                                 learn_sigma=learn_sigma, unrolls=unrolls),
                         params)
    assert isinstance(model, DiffusionUnrolled)
    assert len(model.nets) == (1 if share else unrolls) + (
        1 if share and learn_sigma else 0)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    **torch_kwargs(maps, mask)).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == (2 * x.shape[1] if learn_sigma else x.shape[1])
    assert _rel_l2(got, want) <= TOL


def test_remat_gradients_equal_plain_backward():
    """GRAD_CHECKPOINT recomputes each denoiser in the backward: the same
    gradients as without (DiT, its label dropout on, so the recompute must
    replay the draws)."""
    x, maps, mask, t = operands(7)
    grads = []
    for remat in (False, True):
        cfg = toy_cfg(get_cfg, "DIT")
        cfg.MODEL.PARAMETERS.GRAD_CHECKPOINT = remat
        model = build_model(cfg, torch.Generator().manual_seed(0)).train()
        for p in model.parameters():     # leave the zero-init regime
            with torch.no_grad():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator(
                    ).manual_seed(p.numel())))
        g = torch.Generator().manual_seed(3)
        set_dropout_generator(model, g)
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    **torch_kwargs(maps, mask))
        out.abs().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-6, msg=n)


@pytest.mark.parametrize("model_type", ["DIT", "LATTE"])
def test_bf16_dit_and_latte_build(model_type):
    """A bfloat16 DiT or Latte builds (it raised before this trunk was
    ported): float32 parameters; the patch embedding, every block's
    attention and MLP and the final linear in bfloat16, the adaLN
    modulations and the embedders float32 (the trunks' parity with the JAX
    package: tests/test_torch_dit_bf16.py)."""
    cfg = toy_cfg(get_cfg, model_type)
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "bfloat16"
    net = build_model(cfg).nets[0]
    core = net.dit if model_type == "DIT" else net.latte
    assert all(p.dtype == torch.float32 for p in net.parameters())
    bf, f32 = torch.bfloat16, torch.float32
    block = core.blocks[-1]
    assert core.dtype == bf and core.final_layer.linear.dtype == bf
    assert {block.attn.qkv.dtype, block.attn.proj.dtype, block.mlp.fc1.dtype,
            block.mlp.fc2.dtype} == {bf}
    assert {block.adaLN_modulation.dtype, core.t_embedder.fc1.dtype,
            core.final_layer.adaLN_modulation.dtype} == {f32}


def test_bf16_swin_diff_builds_float32_as_jax():
    """The JAX SwinDiffNet takes no dtype: a bfloat16 config builds the
    float32 trunk there, and here."""
    cfg = toy_cfg(get_cfg, "SWIN_DIFF")
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "bfloat16"
    net = build_denoiser(cfg)
    assert isinstance(net, SwinDiffNet)
    assert all(p.dtype == torch.float32 for p in net.parameters())
