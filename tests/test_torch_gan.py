"""SwinGAN training in the port against the JAX package: the PatchGAN
discriminator at shapes that force flax's asymmetric SAME padding (1e-5),
a 3-step GANTrainer trajectory against the JAX GANTrainer on converted
weights with stochastic depth off (discriminator, adversarial and generator
losses per step within rel 1e-4), fit and --resume through the
train_swin_gan entry point, a GAN checkpoint served through Reconstructor,
the VGG16 perceptual loss and its bilinear resize against the JAX ones on
the same weights (1e-4), and swingan_cfg against its YAML."""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.models.discriminator import (
    PatchDiscriminator3D as JaxDiscriminator,
)
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from dl_swin_gan_tpu.train.gan_trainer import GANTrainState as JaxState
from dl_swin_gan_tpu.train.perceptual import PerceptualLoss as JaxPerceptual
from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.convert import disc_flax_to_torch, flax_to_torch
from dl_swin_gan_tpu_torch.data import Hdf5Dataset
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, write_synthetic_dataset,
)
from dl_swin_gan_tpu_torch.infer import Reconstructor, load_checkpoint_params
from dl_swin_gan_tpu_torch.models.discriminator import (
    PatchDiscriminator3D, same_pads,
)
from dl_swin_gan_tpu_torch.models.swin import DropPath
from dl_swin_gan_tpu_torch.scripts.train_swin_gan import main as train_main
from dl_swin_gan_tpu_torch.solvers import build_solver
from dl_swin_gan_tpu_torch.train import CheckpointManager, GANTrainer, Trainer
from dl_swin_gan_tpu_torch.train.perceptual import (
    TORCHVISION_CONVS, VGG16_PLAN, PerceptualLoss,
)
from dl_swin_gan_tpu_torch.utils.headline import swingan_cfg
from test_torch_gates import seeded_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SWINGAN = REPO / "configs/config_swingan.yaml"
# config_swingan.yaml at toy widths: a 1-unroll Swin generator of 16
# features, a discriminator of 4, and an adversarial weight large enough to
# move the generator's loss
TOY = ["MODEL.PARAMETERS.NUM_FEATURES", 16, "MODEL.PARAMETERS.NUM_UNROLLS", 1,
       "MODEL.GAN.DISC_FEATURES", 4, "MODEL.GAN.ADV_WEIGHT", 0.5,
       "AUG_TRAIN.CROP_READOUT", 32, "OPTIMIZER.ADAM.LR", 0.001]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------- discriminator

def test_same_pads_follow_flax():
    """TF's SAME rule, the smaller half first: an even time axis pads (0, 1)
    at k=3, s=2; 45 rows pad (1, 2) at k=4, s=2."""
    assert same_pads((6,), (3,), (2,)) == [0, 1]
    assert same_pads((45,), (4,), (2,)) == [1, 2]
    assert same_pads((90,), (4,), (2,)) == [1, 1]
    assert same_pads((6, 45), (3, 4), (1, 2)) == [1, 2, 1, 1]


@pytest.mark.parametrize("shape", [(2, 2, 6, 45, 20), (1, 2, 8, 90, 22)])
def test_discriminator_matches_jax(shape):
    """(2, 2, 6, 45, 20): 45 rows pad (1, 2) in the first layer and the 6
    frames (0, 1) in the second; (1, 2, 8, 90, 22) reaches 45 rows in the
    second layer. Output and input gradient within 1e-5."""
    rng = np.random.RandomState(1)
    x = _c64(rng, *shape)
    jdisc = JaxDiscriminator(features=4, num_layers=3)
    params = seeded_params(jdisc, x, seed=2)
    ref = np.asarray(jax.jit(jdisc.apply)({"params": params}, x))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(
        jdisc.apply({"params": params}, v) * g))(x))

    disc = PatchDiscriminator3D(4, 3)
    disc.load_state_dict(disc_flax_to_torch(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = disc(xt)
    assert out.shape == (shape[0], 1) + ref.shape[1:4]
    ours = out.detach().numpy()[:, 0]
    assert _rel(ours, ref[..., 0]) <= 1e-5
    torch.sum(out[:, 0] * torch.from_numpy(g[..., 0])).backward()
    # torch's complex gradient is the conjugate of JAX's
    assert _rel(xt.grad.numpy(), np.conj(jgrad)) <= 1e-5


# ---------------------------------------------------------------- perceptual

@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """Seeded VGG16 weights in torchvision's `features.{i}` layout."""
    rng = np.random.RandomState(7)
    arrays, cin = {}, 3
    widths = [c for c in VGG16_PLAN if c != "M"]
    for i, cout in zip(TORCHVISION_CONVS, widths):
        arrays[f"features.{i}.weight"] = (rng.standard_normal(
            (cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
        arrays[f"features.{i}.bias"] = (0.01 * rng.standard_normal(
            cout)).astype(np.float32)
        cin = cout
    path = tmp_path_factory.mktemp("vgg") / "vgg16.npz"
    np.savez(path, **arrays)
    return str(path)


@pytest.mark.parametrize("hw", [(180, 64), (156, 64), (64, 48), (48, 48)])
def test_bilinear_resize_matches_jax(hw):
    """Every resize of the repo is an upsample to 224, where
    F.interpolate(align_corners=False) and jax.image.resize agree."""
    x = np.random.RandomState(3).standard_normal((2, 3) + hw).astype(
        np.float32)
    ours = F.interpolate(torch.from_numpy(x), size=(224, 224),
                         mode="bilinear", align_corners=False).numpy()
    ref = np.asarray(jax.image.resize(np.moveaxis(x, 1, -1),
                                      (2, 224, 224, 3), "bilinear"))
    assert _rel(ours, np.moveaxis(ref, -1, 1)) <= 1e-6


# (complex input, resize to 224, frames)
PERCEPTUAL_CASES = [(True, True, 1), (False, True, 1), (True, False, 3),
                    (False, False, 3)]


@pytest.mark.parametrize("is_complex,resize,T", PERCEPTUAL_CASES, ids=[
    f"{'complex' if c else 'mag'}-{'224' if r else 'native'}-T{t}"
    for c, r, t in PERCEPTUAL_CASES])
def test_perceptual_loss_matches_jax(vgg_npz, is_complex, resize, T):
    """The loss and its gradient with respect to the prediction, on the
    same VGG weights, within 1e-4."""
    rng = np.random.RandomState(5)
    ref, pred = (_c64(rng, 1, 2, T, 24, 20) for _ in range(2))
    if not is_complex:
        ref, pred = np.abs(ref), np.abs(pred)
    jloss = JaxPerceptual(weights_npz=vgg_npz, resize=resize)
    want, jgrad = jax.jit(jax.value_and_grad(lambda p: jloss(ref, p)))(pred)
    loss = PerceptualLoss(weights_npz=vgg_npz, resize=resize)
    assert loss.pretrained
    pt = torch.from_numpy(pred).requires_grad_(True)
    got = loss(torch.from_numpy(ref), pt)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))
    assert _rel(pt.grad.numpy(), np.conj(np.asarray(jgrad))) <= 1e-4


def test_perceptual_loss_without_weights_warns(monkeypatch, caplog, vgg_npz):
    monkeypatch.delenv("DL_SWIN_GAN_VGG16_NPZ", raising=False)
    with caplog.at_level(logging.WARNING):
        loss = PerceptualLoss()
    assert not loss.pretrained and "no pretrained VGG16" in caplog.text
    again = PerceptualLoss()        # fixed features: the same draw
    assert all(torch.equal(a, b) for a, b in zip(
        loss.model.parameters(), again.model.parameters()))
    monkeypatch.setenv("DL_SWIN_GAN_VGG16_NPZ", vgg_npz)
    assert PerceptualLoss().pretrained


def test_trainer_trains_on_the_vgg_losses():
    """RECON_LOSS.NAME complex_vggloss trains (the metric keys of the JAX
    package), the VGG stays fixed."""
    cfg = load_cfg(str(REPO / "configs/basic/example.yaml"), freeze=False)
    cfg.merge_from_list(["MODEL.PARAMETERS.NUM_UNROLLS", 1,
                         "MODEL.PARAMETERS.NUM_RESBLOCKS", 1,
                         "MODEL.PARAMETERS.NUM_FEATURES", 8,
                         "AUG_TRAIN.CROP_READOUT", 16,
                         "MODEL.RECON_LOSS.NAME", "complex_vggloss"])
    trainer = Trainer(cfg, device="cpu")
    trainer.perceptual.resize = False
    ex = CinePreprocess(cfg, use_seed=True)(
        *make_cine_example(T=8, Y=24, X=24, C=2, E=2, seed=0), "vgg")
    batch = {k: np.asarray(v)[None] for k, v in ex.items()}
    state = trainer.init_state()
    metrics = trainer.train_step(state, batch)
    assert {"Train/complex_vggloss", "Train/mag_vggloss"} <= set(metrics)
    assert np.isfinite(float(metrics["Train/complex_vggloss"]))
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    assert grads and any(float(g.abs().max()) > 0 for g in grads)
    assert all(p.grad is None for p in trainer.perceptual.model.parameters())


# ---------------------------------------------------------------- GAN trainer

def _batches(cfg, n=3, T=8, Y=40, X=40):
    pre = CinePreprocess(cfg, use_seed=True)
    return [{k: np.asarray(v)[None] for k, v in pre(*make_cine_example(
        T=T, Y=Y, X=X, C=4, E=2, seed=i), f"gan_{i}").items()}
        for i in range(n)]


def test_gan_trajectory_matches_jax_trainer():
    """Converted generator and discriminator weights, the same three
    batches, 3 steps with stochastic depth off on both sides: per step the
    discriminator's loss, the adversarial loss and the generator's loss
    (recon + ADV_WEIGHT * adv) within rel 1e-4 of the JAX GANTrainer's,
    which runs the generator forward twice where the port runs it once."""
    cfg = load_cfg(str(SWINGAN), freeze=False)
    cfg.merge_from_list(TOY)
    jcfg = jax_load_cfg(str(SWINGAN), freeze=False)
    jcfg.merge_from_list(TOY)
    batches = _batches(cfg)

    jtrainer = JaxGANTrainer(jcfg)
    jtrainer.set_steps_per_epoch(len(batches))
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    g_params = seeded_params(jtrainer.model, b0["kspace"], b0["maps"],
                             b0["mask"], x0=b0["init_image"], seed=3)
    d_params = seeded_params(jtrainer.disc, b0["target"], seed=4)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), g_params=g_params,
                      g_opt=jtrainer.tx.init(g_params), d_params=d_params,
                      d_opt=jtrainer.d_tx.init(d_params))
    jtrainer.train_model = jtrainer.model       # stochastic depth off
    jtrainer._build_steps()

    trainer = GANTrainer(cfg, device="cpu")
    trainer.set_steps_per_epoch(len(batches))
    state = trainer.init_state(state_dict=flax_to_torch(g_params),
                               disc_state_dict=disc_flax_to_torch(d_params))
    for m in state.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    w = cfg.MODEL.GAN.ADV_WEIGHT
    for b in batches:
        ours = trainer.train_step(state, b)
        jstate, theirs = jtrainer._train_step(jstate, packing.pack(b))
        for key in ("Train/disc_loss", "Train/adv_loss", "Train/complex_l1"):
            assert float(ours[key]) == pytest.approx(float(theirs[key]),
                                                     rel=1e-4), key
        g_ours = float(ours["Train/complex_l1"] + w * ours["Train/adv_loss"])
        g_theirs = float(theirs["Train/complex_l1"]
                         + w * theirs["Train/adv_loss"])
        assert g_ours == pytest.approx(g_theirs, rel=1e-4)
    assert state.step == 3


# the JAX GANTrainer's 3 steps on the bfloat16 generator, in a subprocess
# with XLA's excess precision off (tests/test_torch_bf16.py says why)
_GAN_BF16_JAX = """
import jax, jax.numpy as jnp, numpy as np
from dl_swin_gan_tpu.config import load_cfg
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.gan_trainer import GANTrainer, GANTrainState
d = dict(np.load({inp!r}))
def tree(prefix):
    out = {{}}
    for key, value in d.items():
        if key.startswith(prefix + "/"):
            *parents, leaf = key[len(prefix) + 1:].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {{}})
            node[leaf] = value
    return out
cfg = load_cfg({yaml!r}, freeze=False)
cfg.merge_from_list({toy!r})
trainer = GANTrainer(cfg)
trainer.set_steps_per_epoch(3)
g, dp = tree("g"), tree("d")
state = GANTrainState(step=jnp.zeros((), jnp.int32), g_params=g,
                      g_opt=trainer.tx.init(g), d_params=dp,
                      d_opt=trainer.d_tx.init(dp))
trainer.train_model = trainer.model       # stochastic depth off
trainer._build_steps()
out = {{}}
for i in range(3):
    state, metrics = trainer._train_step(state, packing.pack(
        {{k: v for k, v in tree(f"b{{i}}").items()}}))
    for key in {keys!r}:
        out[f"{{i}}/{{key}}"] = np.asarray(metrics[key])
np.savez({out!r}, **out)
"""


def test_bf16_gan_trajectory_matches_jax_trainer(tmp_path):
    """The bfloat16 Swin generator (CONV_BLOCK.DTYPE bfloat16; the
    discriminator stays float32, as the JAX one takes no dtype) through 3
    GANTrainer steps from the same seeded weights on the same batches,
    stochastic depth off: each step's discriminator, adversarial and
    reconstruction losses within rel 1e-2 of the JAX GANTrainer's (the bf16
    RES trajectory's limit, tests/test_torch_bf16.py; measured 7e-7 to
    7.5e-4)."""
    from test_torch_swin_bf16 import run_jax_bf16

    toy = TOY + ["MODEL.PARAMETERS.CONV_BLOCK.DTYPE", "bfloat16"]
    keys = ("Train/disc_loss", "Train/adv_loss", "Train/complex_l1")
    cfg = load_cfg(str(SWINGAN), freeze=False)
    cfg.merge_from_list(toy)
    jcfg = jax_load_cfg(str(SWINGAN), freeze=False)
    jcfg.merge_from_list(toy)
    batches = _batches(cfg)
    jtrainer = JaxGANTrainer(jcfg)
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    g_params = seeded_params(jtrainer.model, b0["kspace"], b0["maps"],
                             b0["mask"], x0=b0["init_image"], seed=3)
    d_params = seeded_params(jtrainer.disc, b0["target"], seed=4)
    arrays = {}
    for name, tree in (("g", g_params), ("d", d_params)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            arrays[name + "/" + "/".join(p.key for p in path)] = \
                np.asarray(leaf)
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    np.savez(tmp_path / "in.npz", **arrays)
    run_jax_bf16(_GAN_BF16_JAX.format(
        inp=str(tmp_path / "in.npz"), yaml=str(SWINGAN), toy=toy,
        keys=keys, out=str(tmp_path / "jax.npz")))
    theirs = np.load(tmp_path / "jax.npz")

    trainer = GANTrainer(cfg, device="cpu")
    trainer.set_steps_per_epoch(len(batches))
    state = trainer.init_state(state_dict=flax_to_torch(g_params),
                               disc_state_dict=disc_flax_to_torch(d_params))
    for m in state.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    assert state.model.nets[0].trunks[0].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.disc.parameters())
    for i, b in enumerate(batches):
        ours = trainer.train_step(state, b)
        for key in keys:
            assert float(ours[key]) == pytest.approx(
                float(theirs[f"{i}/{key}"]), rel=1e-2), (i, key)
    assert state.step == 3


@pytest.fixture(scope="module")
def gan_data(tmp_path_factory):
    """2 training files and 1 validation file of one 8x40x40 slice each."""
    root = tmp_path_factory.mktemp("gan")
    write_synthetic_dataset(str(root / "train"), num_files=2, slices=1, T=8,
                            Y=40, X=40, C=4, E=2, seed=0)
    write_synthetic_dataset(str(root / "val"), num_files=1, slices=1, T=8,
                            Y=40, X=40, C=4, E=2, seed=100)
    return root


def test_train_swin_gan_fits_resumes_and_serves(gan_data, tmp_path):
    """The entry point trains 1 epoch (2 steps), --resume continues to 4 with
    both optimizers restored, and the checkpoint's generator serves."""
    out = tmp_path / "run"
    argv = ["--config-file", str(SWINGAN), "--device", "cpu",
            *map(str, TOY),
            "DATASET.TRAIN", f"('{gan_data / 'train'}',)",
            "DATASET.VAL", f"('{gan_data / 'val'}',)",
            "DATALOADER.NUM_WORKERS", "1", "LOGGER.LOG_METRICS_EVERY_N_STEPS",
            "1", "OUTPUT_DIR", str(out)]
    assert train_main(argv + ["--max-epochs", "1"]).step == 2
    state = train_main(argv + ["--max-epochs", "2", "--resume"])
    assert state.step == 4
    for opt in (state.optimizer, state.d_optimizer):
        steps = [int(s["step"]) for s in opt.state_dict()["state"].values()]
        assert steps and all(s == 4 for s in steps)

    ckpt = str(out / "checkpoints")
    payload = CheckpointManager(ckpt).restore()
    assert {"model", "optimizer", "disc", "d_optimizer"} <= set(payload)
    cfg = load_cfg(str(SWINGAN), freeze=False)
    cfg.merge_from_list(TOY)
    params = load_checkpoint_params(ckpt)
    assert params.keys() == build_solver(cfg).state_dict().keys()
    torch.testing.assert_close(params, state.model.state_dict())
    val = Hdf5Dataset(str(gan_data / "val"), CinePreprocess(
        cfg, aug_node=cfg.AUG_VAL, use_seed=True))
    batch = {k: v[None] for k, v in val[0].items()}
    _, pred = GANTrainer(cfg, device="cpu").val_step(state, batch)
    recon = Reconstructor(cfg, params, device="cpu")(batch)
    np.testing.assert_allclose(recon, pred.numpy() * batch["scale"][0],
                               rtol=1e-6, atol=1e-7)


def test_swingan_cfg_matches_config_swingan_yaml():
    """Every field."""
    ours, ref = swingan_cfg(), load_cfg(str(SWINGAN))
    assert set(ours) == set(ref)
    for node in ref:
        assert ours[node] == ref[node], node
    assert get_cfg().MODEL.GAN == ours.MODEL.GAN
