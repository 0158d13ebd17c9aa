"""The port's diffusion engine (`diffusion/`), its diffusion solver and the
diffusion serving path against the JAX package's, on the CPU at toy
shapes: the schedules and the respacing in float64 to 1e-12; q_sample, the
posterior, p_mean_variance and p_sample with the JAX package's noise to
1e-5; `p_sample_loop_conditional` over 3 steps with the JAX package's
draws, `training_kspace_loss` and `DiffusionReconstructor` on a toy slice
to 1e-4; `submask_np` and the device pipeline's diffusion draws bit for
bit, its diffusion batches to 2e-4 as the pipeline's other tests; the
converter on the DiT, Latte and SwinDiff trees. The JAX side's weights are
drawn with numpy from `jax.eval_shape` of the init (non-zero adaLN and final
layers: a zero-init model would compare nothing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.data.device_pipeline import DevicePipeline as JaxPipeline
from dl_swin_gan_tpu.diffusion import create_diffusion as jax_create
from dl_swin_gan_tpu.diffusion import respace as jax_respace
from dl_swin_gan_tpu.diffusion.timestep_sampler import (
    LossSecondMomentResampler as JaxResampler,
)
from dl_swin_gan_tpu.infer.reconstruct import (
    DiffusionReconstructor as JaxDiffusionReconstructor,
)
from dl_swin_gan_tpu.ops.sense import SenseOp as JaxSenseOp
from dl_swin_gan_tpu.solvers.diffusion_unrolled import (
    build_diffusion_solver as jax_build_diffusion_solver,
)
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.diffusion_trainer import (
    make_diffusion_denoiser_factory, submask_np as jax_submask_np,
)
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data.device_pipeline import DevicePipeline
from dl_swin_gan_tpu_torch.data.host_ops import submask_np
from dl_swin_gan_tpu_torch.diffusion import create_diffusion, respace
from dl_swin_gan_tpu_torch.diffusion.timestep_sampler import (
    LossSecondMomentResampler, UniformSampler,
)
from dl_swin_gan_tpu_torch.infer.reconstruct import DiffusionReconstructor
from dl_swin_gan_tpu_torch.solvers import build_model
from dl_swin_gan_tpu_torch.solvers.diffusion_unrolled import model_kwargs
from dl_swin_gan_tpu.data.synthetic import make_cine_example
from tests.test_torch_gates import seeded_params

torch.set_num_threads(1)

# [B, E, T, Y, X]: Y and X not multiples of the patch, so the pad-and-crop
# quirk of unpatchify is exercised
B, E, C, T, Y, X = 2, 2, 3, 6, 18, 14
TOL = 1e-4


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def toy_cfg(get, model_type="LATTE", meta="DDPM_X", unrolls=2, share=False,
            learn_sigma=False, features=24, heads=2, layers=2):
    """A toy diffusion config from either package's get_cfg."""
    cfg = get()
    cfg.MODEL.MODEL_TYPE = model_type
    cfg.MODEL.META_ARCHITECTURE = meta
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = unrolls
    p.NUM_RESBLOCKS = 0
    p.NUM_SWINBLOCKS = 1
    p.NUM_LAYERS = layers
    p.NUM_HEADS = heads
    p.NUM_FEATURES = features
    p.NUM_EMAPS = E
    p.SHARE_WEIGHTS = share
    p.LEARN_SIGMA = learn_sigma
    p.FIX_STEP_SIZE = False
    p.MODL.NUM_CG_STEPS = 3
    p.CONV_BLOCK.COMPLEX = False
    return cfg


def operands(seed=0, b=B):
    """x [b,E,T,Y,X] complex, maps [b,E,C,1,Y,X], a binary mask [b,1,T,Y,X]
    and t [b] (int32)."""
    rng = np.random.RandomState(seed)

    def c64(*shape):
        return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                / np.sqrt(2)).astype(np.complex64)

    x = c64(b, E, T, Y, X)
    maps = c64(b, E, C, 1, Y, X) / 2
    mask = (rng.rand(b, 1, T, Y, X) < 0.4).astype(np.float32)
    t = rng.randint(0, 1000, size=b).astype(np.int32)
    return x, maps, mask, t


def jax_kwargs(maps, mask, target=None):
    mask = jnp.asarray(mask)
    maps = jnp.asarray(maps)
    out = dict(A=JaxSenseOp(maps, mask), A_1=JaxSenseOp(maps, 1.0 - mask),
               A_F=JaxSenseOp(maps, None), A_S=JaxSenseOp(maps, mask),
               c=jnp.ones((maps.shape[0],), jnp.int32))
    if target is not None:
        out["fs"] = jnp.asarray(target)
    return out


def torch_kwargs(maps, mask, target=None):
    return model_kwargs(torch.from_numpy(maps), torch.from_numpy(mask),
                        None if target is None else torch.from_numpy(target))


def jax_solver_and_params(cfg, x, maps, mask, seed=0):
    """The JAX DiffusionUnrolled (deterministic) and seeded params."""
    model = jax_build_diffusion_solver(
        cfg, make_diffusion_denoiser_factory(cfg, deterministic=True))
    params = seeded_params(model, jnp.asarray(x), jnp.zeros((x.shape[0],),
                                                           jnp.int32),
                           seed=seed, **jax_kwargs(maps, mask))
    return model, jax.tree_util.tree_map(np.asarray, params)


def torch_solver(cfg, params):
    model = build_model(cfg)
    model.load_state_dict(flax_to_torch(params))
    return model.eval()


def jax_complex_draws(key, shape, n):
    """The complex noise of n JAX sampler steps, in order: per step the key
    is split (key, sub) and `_randn_like(sub, x)` draws re and im from the
    two halves of sub, each N(0, 1/2)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        re = jax.random.normal(k1, shape, jnp.float32) / np.sqrt(2.0)
        im = jax.random.normal(k2, shape, jnp.float32) / np.sqrt(2.0)
        out.append(np.asarray(jax.lax.complex(re, im)))
    return out


def jax_real_draws(key, shape, n):
    """The real noise of n JAX loop steps: per step (key, sub) = split(key)
    and a standard normal draw from sub."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


def replay(draws):
    """A randn(shape, dtype) that hands out `draws` in order."""
    it = iter(draws)

    def randn(shape, dtype):
        d = next(it)
        assert tuple(d.shape) == tuple(shape)
        return torch.from_numpy(np.array(d)).to(dtype)

    return randn


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("sched,steps,respacing", [
    ("linear", 1000, ""), ("linear", 100, ""), ("squaredcos_cap_v2", 1000, ""),
    ("linear", 1000, "10"), ("linear", 1000, "ddim25"),
    ("squaredcos_cap_v2", 300, "5,10,15")])
def test_schedules_and_respacing_match_jax(sched, steps, respacing):
    kw = dict(timestep_respacing=respacing, noise_schedule=sched,
              diffusion_steps=steps, learn_sigma=False, predict_xstart=True)
    ours, ref = create_diffusion(**kw), jax_create(**kw)
    assert ours.num_timesteps == ref.num_timesteps
    assert ours.timestep_map == ref.timestep_map
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "alphas_cumprod_next", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "sqrt_recipm1_alphas_cumprod"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("counts", ["ddim10", "3,7", [4, 4, 2]])
def test_space_timesteps_matches_jax(counts):
    assert respace.space_timesteps(60, counts) == \
        jax_respace.space_timesteps(60, counts)


def test_wrap_t_maps_to_base_timesteps():
    ours = create_diffusion("ddim25", learn_sigma=False)
    t = torch.tensor([0, 3, 24])
    assert ours._wrap_t(t).tolist() == [ours.timestep_map[i] for i in
                                        (0, 3, 24)]


def test_timestep_samplers():
    """Uniform draws stay in range; the loss-second-moment sampler's ring
    buffer, warm-up and weights against the JAX sampler's."""
    diff = create_diffusion("", diffusion_steps=4, learn_sigma=False)
    t, w = UniformSampler(diff).sample(64, torch.Generator().manual_seed(0))
    assert t.min() >= 0 and t.max() < 4 and bool(torch.all(w == 1))
    ours, ref = LossSecondMomentResampler(diff, 3), JaxResampler(diff, 3)
    s, rs = ours.init_state(), ref.init_state()
    rng = np.random.RandomState(0)
    for _ in range(5):
        ts = rng.randint(0, 4, 4).astype(np.int32)
        losses = rng.rand(4).astype(np.float32)
        s = ours.update_with_losses(s, torch.from_numpy(ts),
                                    torch.from_numpy(losses))
        rs = ref.update_with_losses(rs, jnp.asarray(ts), jnp.asarray(losses))
        np.testing.assert_allclose(s[0].numpy(), np.asarray(rs[0]), rtol=1e-7)
        assert s[1].tolist() == np.asarray(rs[1]).tolist()
        np.testing.assert_allclose(ours.weights(s).numpy(),
                                   np.asarray(ref.weights(rs)), rtol=1e-6)
    t, w = ours.sample(8, s, torch.Generator().manual_seed(0))
    assert t.shape == w.shape == (8,)


# ---------------------------------------------------------------- q and p

def _toy_model(xp):
    """An elementwise model of (x, t) for either package."""
    def model(x, t, **kwargs):
        shape = (-1,) + (1,) * (x.ndim - 1)
        return 0.8 * x - 0.1 + 1e-3 * t.reshape(shape)
    return model


@pytest.mark.parametrize("learn_sigma,predict_xstart", [
    (False, True), (True, False), (False, False)])
def test_q_and_p_steps_match_jax(learn_sigma, predict_xstart):
    """q_sample, the posterior, p_mean_variance and p_sample (with the JAX
    package's complex noise) on complex x; the learned-range variance on a
    real x whose model output has twice its channels."""
    kw = dict(timestep_respacing="", noise_schedule="linear",
              learn_sigma=learn_sigma, predict_xstart=predict_xstart,
              diffusion_steps=1000)
    ours, ref = create_diffusion(**kw), jax_create(**kw)
    x, _, _, t = operands()
    if learn_sigma:
        x = np.concatenate([x.real, x.imag], axis=1)

        def doubled(xp):
            base = _toy_model(xp)
            cat = torch.cat if xp is torch else jnp.concatenate
            return lambda v, tt, **k: cat([base(v, tt), 0.3 * v], 1)
        m_ours, m_ref = doubled(torch), doubled(jnp)
    else:
        m_ours, m_ref = _toy_model(torch), _toy_model(jnp)
    tt, jt = torch.from_numpy(t).long(), jnp.asarray(t)
    xs, js = torch.from_numpy(x), jnp.asarray(x)
    tol = dict(rtol=1e-5, atol=1e-5)

    np.testing.assert_allclose(ours.q_sample(xs, tt, xs * 0.5).numpy(),
                               np.asarray(ref.q_sample(js, jt, js * 0.5)),
                               **tol)
    for a, b in zip(ours.q_posterior_mean_variance(xs * 0.3, xs, tt),
                    ref.q_posterior_mean_variance(js * 0.3, js, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    out = ours.p_mean_variance(m_ours, xs, tt, clip_denoised=False)
    rout = ref.p_mean_variance(m_ref, js, jt, clip_denoised=False)
    for key in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(
            np.broadcast_to(out[key].numpy(), np.shape(rout[key])),
            np.asarray(rout[key]), err_msg=key, **tol)

    key = jax.random.PRNGKey(3)
    if np.iscomplexobj(x):
        # p_sample draws with the key as given, not a split of it
        k1, k2 = jax.random.split(key)
        noise = np.array(jax.lax.complex(
            jax.random.normal(k1, x.shape) / np.sqrt(2.0),
            jax.random.normal(k2, x.shape) / np.sqrt(2.0)))
    else:
        noise = np.array(jax.random.normal(key, x.shape))
    t0 = t.copy()
    t0[0] = 0     # no noise at t = 0
    got = ours.p_sample(m_ours, xs, torch.from_numpy(t0).long(),
                        clip_denoised=False,
                        noise=torch.from_numpy(noise))["sample"].numpy()
    want = np.asarray(ref.p_sample(key, m_ref, js, jnp.asarray(t0),
                                   clip_denoised=False)["sample"])
    np.testing.assert_allclose(got, want, **tol)


def test_ddim_and_bpd_loops_match_jax():
    """The DDIM pair and loop (eta 0.5, so its noise counts) and the
    variational bound over a 6-step process, on a real x with the JAX
    package's draws."""
    kw = dict(timestep_respacing="", diffusion_steps=6, learn_sigma=False,
              predict_xstart=False)
    ours, ref = create_diffusion(**kw), jax_create(**kw)
    m_ours, m_ref = _toy_model(torch), _toy_model(jnp)
    x = np.tanh(operands(8)[0].real)
    xs, js = torch.from_numpy(x), jnp.asarray(x)
    key = jax.random.PRNGKey(11)
    tol = dict(rtol=1e-5, atol=1e-5)

    want = ref.ddim_sample_loop(key, m_ref, noise=js, eta=0.5,
                                clip_denoised=True)
    got = ours.ddim_sample_loop(m_ours, noise=xs, eta=0.5,
                                clip_denoised=True,
                                randn=replay(jax_real_draws(key, x.shape, 6)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    t = torch.tensor([0, 4])
    rev = ours.ddim_reverse_sample(m_ours, xs, t)["sample"]
    jrev = ref.ddim_reverse_sample(m_ref, js, jnp.asarray([0, 4]))["sample"]
    np.testing.assert_allclose(rev.numpy(), np.asarray(jrev), **tol)

    bpd = ours.calc_bpd_loop(m_ours, xs, randn=replay(
        jax_real_draws(key, x.shape, 6)))
    jbpd = ref.calc_bpd_loop(key, m_ref, js)
    for name in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        np.testing.assert_allclose(bpd[name].numpy(),
                                   np.asarray(jbpd[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_learned_sigma_training_losses_match_jax():
    """training_losses with LEARN_SIGMA: the eps MSE plus the rescaled
    variational bound of the frozen mean, with the JAX package's noise."""
    kw = dict(timestep_respacing="", learn_sigma=True, predict_xstart=False)
    ours, ref = create_diffusion(**kw), jax_create(**kw)
    x, _, _, t = operands(9)

    def doubled(xp):
        cat = torch.cat if xp is torch else jnp.concatenate
        return lambda v, tt, **k: cat([0.7 * v, 0.2 * v], 1)

    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, (B, 2 * E, T, Y, X)))
    terms, _, _ = ref.training_losses(key, doubled(jnp), jnp.asarray(x),
                                      jnp.asarray(t))
    got, _, _ = ours.training_losses(doubled(torch), torch.from_numpy(x),
                                     torch.from_numpy(t).long(),
                                     noise=torch.from_numpy(noise))
    for name in ("mse", "vb", "loss"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(terms[name]), rtol=1e-4,
                                   err_msg=name)


def test_samplers_need_an_explicit_draw():
    diff = create_diffusion("", diffusion_steps=10, learn_sigma=False)
    x = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="randn"):
        diff.p_sample(_toy_model(torch), x, torch.tensor([3]))


def test_training_kspace_loss_matches_jax():
    """The DDPM_X loss of a toy Latte solver, the JAX package's noise fed
    to the port."""
    jcfg = toy_cfg(jax_get_cfg)
    x, maps, mask, t = operands(1)
    target = x * 0.7
    jmodel, params = jax_solver_and_params(jcfg, x, maps, mask)
    model = torch_solver(toy_cfg(get_cfg), params)
    kw = dict(timestep_respacing="", learn_sigma=False, predict_xstart=True)
    key = jax.random.PRNGKey(5)
    ri_shape = (B, 2 * E, T, Y, X)
    noise = np.array(jax.random.normal(key, ri_shape, jnp.float32))

    @jax.jit
    def jax_loss(p):
        return jax_create(**kw).training_kspace_loss(
            key, lambda v, tt, **k: jmodel.apply({"params": p}, v, tt, **k),
            jnp.asarray(target), jnp.asarray(t),
            jax_kwargs(maps, mask, target))

    terms, pred, x_t = jax_loss(params)
    with torch.no_grad():
        ours, opred, ox_t = create_diffusion(**kw).training_kspace_loss(
            model, torch.from_numpy(target), torch.from_numpy(t).long(),
            torch_kwargs(maps, mask, target), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ox_t.numpy(), np.asarray(x_t), rtol=1e-5,
                               atol=1e-6)
    assert _rel_l2(opred.numpy(), np.asarray(pred)) <= TOL
    assert abs(float(ours["loss"]) - float(terms["loss"])) <= \
        TOL * abs(float(terms["loss"]))


@pytest.mark.parametrize("model_type", ["LATTE", "DIT"])
def test_p_sample_loop_conditional_matches_jax(model_type):
    """3 reverse steps with hard DC after all but t = 0, the model getting
    every kwarg, the JAX package's draws fed to the port."""
    jcfg = toy_cfg(jax_get_cfg, model_type)
    x, maps, mask, _ = operands(2)
    jmodel, params = jax_solver_and_params(jcfg, x, maps, mask)
    model = torch_solver(toy_cfg(get_cfg, model_type), params)
    kw = dict(timestep_respacing="", learn_sigma=False, predict_xstart=True,
              diffusion_steps=3)
    key = jax.random.PRNGKey(9)

    def jfn(v, tt, **k):
        return jmodel.apply({"params": params}, v, tt, **k)

    want = np.asarray(jax_create(**kw).p_sample_loop_conditional(
        key, jfn, jnp.asarray(x), jax_kwargs(maps, mask),
        clip_denoised=False))
    with torch.no_grad():
        got = create_diffusion(**kw).p_sample_loop_conditional(
            model, torch.from_numpy(x), torch_kwargs(maps, mask),
            clip_denoised=False,
            randn=replay(jax_complex_draws(key, x.shape, 3))).numpy()
    assert np.isfinite(got).all() and _rel_l2(got, want) <= TOL


# ---------------------------------------------------------------- data

def test_submask_np_matches_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    mask = (rng.rand(2, 1, 5, 12, 8) < 0.3).astype(np.float32)
    mask[:, :, :, :, 1:] = mask[:, :, :, :, :1]     # whole ky lines
    a = submask_np(mask, 0.9, np.random.RandomState(1099))
    b = jax_submask_np(mask, 0.9, np.random.RandomState(1099))
    for got, want in zip(a, b):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (a[0] + a[1] == mask).all()              # a split of the lines


def _pipe_cfg(get):
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "DDPM_X"
    cfg.MODEL.PARAMETERS.SLWIN_INIT = False
    cfg.AUG_TRAIN.CROP_READOUT = 16
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (3, 4)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.SEED = 7
    return cfg


def test_pipeline_diffusion_batches_match_jax():
    """Two steps of seeded draws (the submask stream runs on across steps)
    and their builds: the draws bit for bit, no raw k-space, the masks as
    float, the physics to 2e-4."""
    ours = DevicePipeline(_pipe_cfg(get_cfg), use_seed=True, diffusion=True,
                          device="cpu")
    theirs = JaxPipeline(_pipe_cfg(jax_get_cfg), use_seed=True,
                         diffusion=True)
    for i in range(2):
        k, m, _ = make_cine_example(T=6, Y=32, X=24, C=4, E=2, seed=i)
        params = ours.draw_params(f"f{i}", k.shape)
        ref_params = theirs.draw_params(f"f{i}", k.shape)
        assert set(params) == set(ref_params)
        for key in params:
            assert np.array_equal(params[key], ref_params[key]), key
        got = {key: v.numpy() for key, v in
               ours.build(ours.upload_raw(k, m), params).items()}
        ref = packing.unpack_np(theirs.build(theirs.upload_raw(k, m),
                                             ref_params))
        assert set(got) == set(ref) and "kspace" not in got
        for key in ("mask_r", "mask_p", "mask"):
            assert got[key].dtype == np.float32
            assert np.array_equal(got[key], ref[key]), key
        for key in ("maps", "target", "init_image", "scale"):
            mag = np.abs(ref[key]).max()
            np.testing.assert_allclose(got[key], ref[key], rtol=2e-4,
                                       atol=2e-5 * max(mag, 1.0),
                                       err_msg=key)


# ---------------------------------------------------------------- serving

def test_diffusion_reconstructor_matches_jax():
    """A toy Latte-2u (shared weights) served at 3 sampling steps, the JAX
    reconstructor's draws (PRNGKey(seed)) fed to the port; output * scale."""
    jcfg = toy_cfg(jax_get_cfg, share=True)
    x, maps, mask, _ = operands(3, b=1)
    _, params = jax_solver_and_params(jcfg, x, maps, mask)
    batch = {"init_image": x, "maps": maps, "mask": mask,
             "scale": np.array([1.7], np.float32),
             "kspace": np.zeros((1, C, T, Y, X), np.complex64)}
    want = JaxDiffusionReconstructor(jcfg, params, sample_steps=3,
                                     seed=4)(batch)
    ours = DiffusionReconstructor(
        toy_cfg(get_cfg, share=True), flax_to_torch(params), sample_steps=3,
        device="cpu",
        randn=replay(jax_complex_draws(jax.random.PRNGKey(4), x.shape, 3)))
    got = ours(batch)
    assert got.dtype == np.complex64 and got.shape == x.shape
    assert _rel_l2(got, want) <= TOL
    # the default: a generator seeded per call, so calls repeat
    ours.randn = None
    assert np.array_equal(ours(batch), ours(batch))


def test_diffusion_reconstructor_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = toy_cfg(get_cfg)
    params = build_model(cfg).state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionReconstructor(cfg, params)


# ---------------------------------------------------------------- converter

@pytest.mark.parametrize("model_type,meta,share,learn_sigma", [
    ("DIT", "DDPM_E", False, True), ("DIT", "DDPM_X", True, False),
    ("LATTE", "dlespirit", True, False), ("LATTE", "DDPM_E", True, True),
    ("SWIN_DIFF", "modl", False, False)])
def test_flax_to_torch_covers_diffusion_trees(model_type, meta, share,
                                              learn_sigma):
    """Every leaf of the JAX solver's tree lands on a torch parameter of the
    same size and every torch parameter is covered (load_state_dict strict),
    the nets numbered by rank where LEARN_SIGMA skips an index."""
    jcfg = toy_cfg(jax_get_cfg, model_type, meta, share=share,
                   learn_sigma=learn_sigma)
    x, maps, mask, _ = operands(4, b=1)
    _, params = jax_solver_and_params(jcfg, x, maps, mask)
    state = flax_to_torch(params)
    model = build_model(toy_cfg(get_cfg, model_type, meta, share=share,
                                learn_sigma=learn_sigma))
    model.load_state_dict(state)
    n_leaves = sum(np.asarray(v).size for v in
                   jax.tree_util.tree_leaves(params))
    assert n_leaves == sum(p.numel() for p in model.parameters())
    with pytest.raises(KeyError):
        flax_to_torch({**params, "mystery": np.zeros(1)})
