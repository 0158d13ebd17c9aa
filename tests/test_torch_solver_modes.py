"""The hqs (MoDL), dc and none rules of the port's UnrolledSolver against the
JAX package's, on the same numpy-seeded weights: the output and the
gradients of every parameter within rel L2 1e-4 (float32 on both sides,
sums in other orders; the hqs rule runs 3 CG steps per unroll), the
SENSE-normal launches per forward, and the META_ARCHITECTURE names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu.solvers import build_solver as jax_build_solver
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.kernels import sense_normal as SN
from dl_swin_gan_tpu_torch.solvers import build_model, build_solver
from test_torch_gates import seeded_params

torch.set_num_threads(1)

TOL = 1e-4
CG_STEPS = 3
# (META_ARCHITECTURE, FIX_STEP_SIZE, the solver's scalar)
CASES = [("modl", True, "lamda"), ("hqs", False, "lamda"),
         ("ddpm_x", False, None), ("dc", True, None),
         ("ddpm_e", False, None), ("none", False, None)]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfg(cfg, meta, fix=False, model_type="RES"):
    cfg.MODEL.MODEL_TYPE = model_type
    cfg.MODEL.META_ARCHITECTURE = meta
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = 2
    p.NUM_RESBLOCKS = 1
    p.NUM_FEATURES = 8
    p.NUM_EMAPS = 2
    p.RR = 3
    p.FIX_STEP_SIZE = fix
    p.MODL.NUM_CG_STEPS = CG_STEPS
    p.CONV_BLOCK.COMPLEX = False
    return cfg


def _inputs(B=2, E=2, C=3, T=6, Y=12, X=10):
    """y, maps, mask, x0 and the cotangent g, from one seed."""
    rng = np.random.RandomState(0)

    def c64(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    maps = (c64(B, E, C, 1, Y, X) / np.sqrt(C)).astype(np.complex64)
    mask = (rng.rand(B, 1, T, Y, X) < 0.4).astype(np.float32)
    y = (c64(B, C, T, Y, X) * mask).astype(np.complex64)
    return y, maps, mask, c64(B, E, T, Y, X), c64(B, E, T, Y, X)


def _jax_side(jcfg, scalar):
    y, maps, mask, x0, g = _inputs()
    model = jax_build_solver(jcfg, lambda: jax_build_denoiser(jcfg))
    params = dict(seeded_params(model, y, maps, mask, x0))
    if scalar is not None:
        assert params[scalar].shape == (1,)
        params[scalar] = np.array([0.5], np.float32)

    def loss(p):
        out = model.apply({"params": p}, y, maps, mask, x0=x0)
        return jnp.sum(jnp.real(jnp.conj(g) * out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)    # noqa: E731
    return to_np(params), np.asarray(out), to_np(grads)


@pytest.mark.parametrize("meta,fix,scalar", CASES,
                         ids=[f"{m}-{'fixed' if f else 'learned'}"
                              for m, f, _ in CASES])
def test_solver_mode_matches_jax(meta, fix, scalar, monkeypatch):
    params, ref, jgrads = _jax_side(_cfg(jax_get_cfg(), meta, fix), scalar)
    assert (scalar in params) if scalar else not (
        {"step_size", "lamda"} & set(params))
    model = build_solver(_cfg(get_cfg(), meta, fix))
    model.load_state_dict(flax_to_torch(params))
    y, maps, mask, x0, g = (torch.from_numpy(a) for a in _inputs())
    calls = []
    wrapper = SN.sense_normal
    monkeypatch.setattr(SN, "sense_normal",
                        lambda *a: calls.append(1) or wrapper(*a))
    out = model(y, maps, mask, x0=x0)
    # hqs: one call of the SENSE-normal wrapper (one kernel launch on the
    # card) for each CG solve's initial residual and one per CG step; dc
    # and none call it never
    assert len(calls) == (2 * (1 + CG_STEPS) if scalar else 0)
    torch.sum(torch.real(g.conj() * out)).backward()
    assert _rel_l2(out.detach().numpy(), ref) <= TOL

    want = flax_to_torch(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, grad in grads.items():
        if name == scalar and fix:
            # FIX_STEP_SIZE stops mu's gradient on both sides
            assert grad is None and float(want[name].abs().max()) == 0.0
            continue
        assert grad is not None, name
        assert _rel_l2(grad.numpy(), want[name].numpy()) <= TOL, name


def test_hqs_with_an_se_denoiser_matches_jax():
    """MoDL with the SE trunk: the solver and the gated denoiser together."""
    params, ref, _ = _jax_side(_cfg(jax_get_cfg(), "modl", model_type="SE"),
                               "lamda")
    model = build_solver(_cfg(get_cfg(), "modl", model_type="SE"))
    model.load_state_dict(flax_to_torch(params))
    y, maps, mask, x0, _ = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        out = model(y, maps, mask, x0=x0).numpy()
    assert _rel_l2(out, ref) <= TOL


def test_hqs_reads_num_cg_steps():
    """MODL.NUM_CG_STEPS reaches the solver; the rule's scalar is lamda,
    initialised to 0.1, and pgd keeps step_size at -2.0."""
    cfg = _cfg(get_cfg(), "modl")
    cfg.MODEL.PARAMETERS.MODL.NUM_CG_STEPS = 7
    model = build_solver(cfg)
    assert model.dc_mode == "hqs" and model.num_cg_steps == 7
    assert model.lamda.tolist() == [pytest.approx(0.1)]
    assert not hasattr(model, "step_size")
    pgd = build_solver(_cfg(get_cfg(), "dlespirit"))
    assert pgd.step_size.tolist() == [-2.0] and not hasattr(pgd, "lamda")


@pytest.mark.parametrize("meta", ["ddpm_z", "unrolled", "dslr-cg-v9"])
def test_unknown_meta_architecture_raises(meta):
    with pytest.raises(ValueError, match="META_ARCHITECTURE"):
        build_model(_cfg(get_cfg(), meta))
