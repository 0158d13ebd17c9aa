"""The torch port's training path against the JAX package: metrics and
losses, CinePreprocess bit for bit, the loader, the LR schedule, clipping,
checkpoints, fit/resume, the command line, DropPath under remat, and the
Trainer's loss trajectory against the JAX Trainer on converted weights."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.data.dataset import DataLoader as JaxDataLoader
from dl_swin_gan_tpu.data.preprocess import CinePreprocess as JaxPreprocess
from dl_swin_gan_tpu.ops import metrics as JM
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.losses import compute_metrics as jax_compute_metrics
from dl_swin_gan_tpu.train.train_state import make_lr_schedule as jax_schedule
from dl_swin_gan_tpu.train.trainer import Trainer as JaxTrainer
from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data import DataLoader, Hdf5Dataset
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, write_synthetic_dataset,
)
from dl_swin_gan_tpu_torch.infer import Reconstructor, load_checkpoint_params
from dl_swin_gan_tpu_torch.models.swin import DropPath, set_dropout_generator
from dl_swin_gan_tpu_torch.ops import metrics as M
from dl_swin_gan_tpu_torch.solvers import build_solver
from dl_swin_gan_tpu_torch.train import (
    CheckpointManager, Trainer, clip_by_global_norm_, compute_metrics,
    make_lr_schedule,
)
from dl_swin_gan_tpu_torch.train.cli import run_training
from dl_swin_gan_tpu_torch.utils.headline import swin_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- metrics

def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("weight", [False, True])
def test_metrics_match_jax(weight):
    """float32 on both sides, sums in other orders: 1e-5 relative."""
    rng = np.random.RandomState(3)
    ref = _complex(rng, (2, 2, 6, 12, 10))
    pred = ref + 0.1 * _complex(rng, ref.shape)
    tr, tp = torch.from_numpy(ref), torch.from_numpy(pred)
    jr, jp = jnp.asarray(ref), jnp.asarray(pred)
    for name in ("l1", "l2", "psnr", "perp_loss"):
        np.testing.assert_allclose(
            float(getattr(M, name)(tr, tp, weight)),
            float(getattr(JM, name)(jr, jp, weight)), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(M.calc_weight(tr).numpy(),
                               np.asarray(JM.calc_weight(jr)), rtol=1e-5)
    ours = compute_metrics(tp, tr, weight=weight, tag="Train")
    theirs = jax_compute_metrics(jp, jr, weight=weight, tag="Train")
    assert set(ours) == set(theirs)
    for key in ours:
        np.testing.assert_allclose(float(ours[key]), float(theirs[key]),
                                   rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------- host data

@pytest.mark.parametrize("crop_readout,zpad_pe,slwin", [
    (0, 0, False), (48, 0, True), (48, 40, True)])
def test_cine_preprocess_bit_exact_with_jax(crop_readout, zpad_pe, slwin):
    """Seeded by the file name, as validation runs it: every array equal
    bit for bit (the readout and phase-encode crops, flips, mask,
    normalisation and sliding-window init)."""
    results = []
    for make_cfg, Pre in ((get_cfg, CinePreprocess),
                          (jax_get_cfg, JaxPreprocess)):
        cfg = make_cfg()
        cfg.AUG_TRAIN.CROP_READOUT = crop_readout
        cfg.AUG_TRAIN.ZPAD_PE = zpad_pe
        cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (8, 10)
        cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.25
        cfg.MODEL.PARAMETERS.SLWIN_INIT = slwin
        k, m, t = make_cine_example(T=10, Y=64, X=96, C=4, E=2, seed=3)
        results.append(Pre(cfg, use_seed=True)(k, m, t, "parity_case.h5"))
    ours, theirs = results
    assert set(ours) == set(theirs)
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_preprocess_lr_decom_raises():
    """lr_decom works (tests/test_torch_dslr.py holds it bit for bit against
    the JAX package); blocks that do not overlap, which the reference never
    had, raise."""
    cfg = get_cfg()
    cfg.AUG_TRAIN.CROP_READOUT = 0
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (4, 5)
    cfg.MODEL.PARAMETERS.DSLR.OVERLAPPING = False
    pre = CinePreprocess(cfg, use_seed=True, lr_decom=True)
    with pytest.raises(ValueError, match="overlapping"):
        pre(*make_cine_example(T=4, Y=24, X=16, C=2, E=1, seed=0), "x.h5")


class _Examples:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_dataloader_order_matches_jax(shuffle, drop_last):
    def order(Loader):
        loader = Loader(_Examples(), batch_size=3, shuffle=shuffle, seed=4,
                        drop_last=drop_last, prefetch=1)
        epochs = [[b["x"][:, 0, 0].tolist() for b in loader]
                  for _ in range(2)]
        return len(loader), epochs

    n, ours = order(DataLoader)
    assert (n, ours) == order(JaxDataLoader)
    assert n == (3 if drop_last else 4)
    assert all(len(epoch) == n for epoch in ours)
    if shuffle:
        assert ours[0] != ours[1]     # reshuffled every epoch


def test_dataloader_early_exit_releases_producer():
    loader = DataLoader(_Examples(), batch_size=1, shuffle=False, prefetch=1)
    before = threading.active_count()
    for _ in range(3):
        for _batch in loader:
            break        # abandon the epoch with the queue full
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("steps_per_epoch,step_size,accum", [
    (7, 2, 1), (294, 3, 1), (8, 2, 4), (9, 1, 2)])
def test_lr_schedule_matches_jax(steps_per_epoch, step_size, accum):
    cfgs = []
    for make_cfg in (get_cfg, jax_get_cfg):
        cfg = make_cfg()
        cfg.OPTIMIZER.ADAM.LR = 4e-4
        cfg.LR_SCHEDULER.STEP_SIZE = step_size
        cfg.LR_SCHEDULER.GAMMA = 0.1
        cfg.OPTIMIZER.GRAD_ACCUM_ITERS = accum
        cfgs.append(cfg)
    ours = make_lr_schedule(cfgs[0], steps_per_epoch)
    theirs = jax_schedule(cfgs[1], steps_per_epoch)
    for update in range(0, 10 * steps_per_epoch, max(1, steps_per_epoch // 7)):
        np.testing.assert_allclose(ours(update), float(theirs(update)),
                                   rtol=1e-6, err_msg=str(update))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(0)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    ref = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())[0]
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(ours, max_norm)
    np.testing.assert_allclose(float(norm),
                               np.sqrt(sum((g ** 2).sum() for g in grads)),
                               rtol=1e-6)
    for a, b, g in zip(ours, ref, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        if max_norm == 100.0:
            np.testing.assert_array_equal(a.numpy(), g)   # untouched


def test_ema_follows_jax_ema_update():
    """With use_ema, the state carries a Polyak average of the parameters,
    updated after every train step as the JAX package's ema_update does."""
    from dl_swin_gan_tpu.train.train_state import ema_update as jax_ema

    cfg = load_cfg(str(REPO / "configs/basic/example.yaml"), freeze=False)
    cfg.merge_from_list(_res_overrides(unrolls=1))
    cfg.AUG_TRAIN.CROP_READOUT = 0
    trainer = Trainer(cfg, device="cpu", use_ema=True, ema_decay=0.9)
    state = trainer.init_state()
    before = {k: v.clone() for k, v in state.ema.items()}
    ex = CinePreprocess(cfg, use_seed=True)(
        *make_cine_example(T=8, Y=24, X=16, C=4, E=2, seed=0), "ema")
    trainer.train_step(state, {k: np.asarray(v)[None] for k, v in ex.items()})
    params = {k: v.detach().numpy() for k, v in
              state.model.named_parameters()}
    ref = jax_ema({k: v.numpy() for k, v in before.items()}, params, 0.9)
    assert set(state.ema) == set(params)
    for name, value in state.ema.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(ref[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert not torch.equal(state.ema["nets.0.head.conv.weight"],
                           before["nets.0.head.conv.weight"])


# ---------------------------------------------------------------- checkpoints

def _w(v=0.0):
    return {"w": torch.arange(4, dtype=torch.float32) + v}


def test_checkpoint_duplicate_step_keeps_metrics(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), monitor="Validate MSE")
    mgr.save(8, _w())                                    # step-interval save
    mgr.save(8, _w(), metrics={"Validate MSE": 0.5})     # validation, same step
    assert mgr.best_step() == 8
    mgr.save(16, _w(1), metrics={"Validate MSE": 0.9})   # worse: best stays 8
    assert mgr.best_step() == 8
    mgr.save(16, _w(2))                                  # metric-less: no-op
    assert mgr.best_step() == 8
    torch.testing.assert_close(mgr.restore(step=mgr.best_step())["w"],
                               _w()["w"])
    torch.testing.assert_close(mgr.restore(step=16)["w"], _w(1)["w"])
    # a new manager on the same directory sees the same steps and metrics
    again = CheckpointManager(str(tmp_path / "ck"), monitor="Validate MSE")
    assert again.best_step() == 8 and again.latest_step() == 16


def test_checkpoint_best_retention_mode_max(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), monitor="Validate SSIM",
                            mode="max")
    mgr.save(8, _w(), metrics={"Validate SSIM": 0.9})    # the genuine best
    mgr.save(16, _w())                                   # periodic
    mgr.save(24, _w(), metrics={"Validate SSIM": 0.5})   # worse validation
    assert mgr.best_step() == 8
    assert mgr.all_steps() == [8, 24] and mgr.latest_step() == 24


def test_checkpoint_keeps_latest_even_when_worse(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), monitor="Validate MSE")
    mgr.save(8, _w(), metrics={"Validate MSE": 0.5})
    mgr.save(16, _w(), metrics={"Validate MSE": 0.9})
    mgr.save(24, _w(3), metrics={"Validate MSE": 0.8})
    assert mgr.best_step() == 8 and mgr.latest_step() == 24
    assert mgr.all_steps() == [8, 24]          # neither best nor latest: gone
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "index.json", "step_000000008.pt", "step_000000024.pt"]
    torch.testing.assert_close(mgr.restore()["w"], _w(3)["w"])


# ---------------------------------------------------------------- fit

def _res_overrides(unrolls=2):
    return ["MODEL.PARAMETERS.NUM_UNROLLS", unrolls,
            "MODEL.PARAMETERS.NUM_RESBLOCKS", 1,
            "MODEL.PARAMETERS.NUM_FEATURES", 8,
            "AUG_TRAIN.CROP_READOUT", 16,
            "AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS", (4, 5),
            "AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY", 0.0,
            "AUG_VAL.UNDERSAMPLE.ACCELERATIONS", (4, 5),
            "OPTIMIZER.ADAM.LR", 0.002]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """example.yaml at toy widths, on 2 + 1 synthetic slices of 8x24x24."""
    root = tmp_path_factory.mktemp("fit")
    write_synthetic_dataset(str(root / "train"), num_files=2, slices=1, T=8,
                            Y=24, X=24, C=4, E=2, seed=0)
    write_synthetic_dataset(str(root / "val"), num_files=1, slices=1, T=8,
                            Y=24, X=24, C=4, E=2, seed=100)
    cfg = load_cfg(str(REPO / "configs/basic/example.yaml"), freeze=False)
    cfg.merge_from_list(_res_overrides())
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 1
    cfg.DATASET.TRAIN = (str(root / "train"),)
    cfg.DATASET.VAL = (str(root / "val"),)
    cfg.OUTPUT_DIR = str(root / "out")
    return cfg


def test_fit_checkpoints_resumes_and_reconstructs(tiny):
    import json

    state = Trainer(tiny, device="cpu").fit(max_epochs=2)
    assert state.step == 4      # 2 epochs x 2 examples at batch 1
    ckpt_dir = os.path.join(tiny.OUTPUT_DIR, "checkpoints")
    mgr = CheckpointManager(ckpt_dir)
    assert mgr.latest_step() == 4 and mgr.best_step() in (2, 4)
    with open(os.path.join(tiny.OUTPUT_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r["Train/complex_l1"] for r in recs if "Train/complex_l1" in r]
    assert len(train) == 4 and train[-1] < train[0]
    assert any("Validate/complex_l1" in r for r in recs)

    # resume restores the epoch clock: max_epochs is a total
    assert Trainer(tiny, device="cpu").fit(max_epochs=3, resume=True).step == 6
    resumed = Trainer(tiny, device="cpu").fit(max_epochs=2, resume=True)
    assert resumed.step == 6
    opt = resumed.optimizer.state_dict()["state"]
    assert opt and all(int(s["step"]) == 6 for s in opt.values())

    # the trained weights reconstruct through the Reconstructor
    params = load_checkpoint_params(ckpt_dir)
    torch.testing.assert_close(params, {k: v.cpu() for k, v in
                                        resumed.model.state_dict().items()})
    val = Hdf5Dataset(tiny.DATASET.VAL[0], CinePreprocess(
        tiny, aug_node=tiny.AUG_VAL, use_seed=True))
    batch = {k: v[None] for k, v in val[0].items()}
    _, pred = Trainer(tiny, device="cpu").val_step(resumed, batch)
    recon = Reconstructor(tiny, params, device="cpu")(batch)
    np.testing.assert_allclose(recon, pred.numpy() * batch["scale"][0],
                               rtol=1e-6, atol=1e-7)


def test_run_training_synthetic_data(tmp_path):
    out = tmp_path / "run"
    state = run_training(
        lambda cfg, device: Trainer(cfg, device=device), "test",
        ["--config-file", str(REPO / "configs/basic/example.yaml"),
         "--synthetic-data", "--max-epochs", "1", "--device", "cpu",
         *map(str, _res_overrides(unrolls=1)), "AUG_TRAIN.CROP_READOUT", "48",
         "OUTPUT_DIR", str(out)])
    assert state.step == 8      # 4 files x 2 slices, batch 1
    assert sorted(os.listdir(out / "data")) == ["train", "val"]
    assert CheckpointManager(str(out / "checkpoints")).latest_step() == 8


def test_trainer_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(swin_cfg())
    assert Trainer(swin_cfg(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("change,match", [
    (("MODEL.STRATEGY", "fsdp"), "Queue 1 item 12"),
])
def test_unported_training_options_raise(change, match):
    cfg = swin_cfg()
    cfg.merge_from_list(list(change))
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, device="cpu")


def test_device_pipeline_option_feeds_training():
    """DATALOADER.DEVICE_PIPELINE, once refused, now selects the device
    pipeline at batch 1 (tests/test_torch_device_pipeline.py fits through
    it)."""
    cfg = swin_cfg()
    cfg.DATALOADER.DEVICE_PIPELINE = True
    assert Trainer(cfg, device="cpu")._use_device_pipeline()
    cfg.DATALOADER.DEVICE_PIPELINE = False
    assert not Trainer(cfg, device="cpu")._use_device_pipeline()


def test_pretrained_option_imports_swin_weights(tmp_path):
    """MODEL.PARAMETERS.PRETRAINED, once refused, now seeds config_swin's
    trunks from a 2D Swin checkpoint at init_state
    (tests/test_torch_swin_import.py holds the import against JAX)."""
    cfg = swin_cfg()
    qkv = np.random.default_rng(0).standard_normal((480, 160)).astype("f")
    path = str(tmp_path / "swin2d.pth")
    torch.save({"model": {"layers.0.blocks.5.attn.qkv.weight":
                          torch.from_numpy(qkv)}}, path)
    cfg.MODEL.PARAMETERS.PRETRAINED = path
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 2
    model = Trainer(cfg, device="cpu").init_state().model
    for net in model.nets:
        np.testing.assert_array_equal(
            net.trunks[0].layers[0].blocks[5].attn.qkv.weight.detach(), qkv)


def test_swin_cfg_training_fields_match_yaml():
    ours, ref = swin_cfg(), load_cfg(str(REPO / "configs/config_swin.yaml"))
    for node in ("OPTIMIZER", "LR_SCHEDULER", "DATALOADER", "EVAL", "LOGGER",
                 "AUG_TRAIN", "AUG_VAL"):
        assert ours[node] == ref[node], node
    assert ours.MODEL == ref.MODEL


# ---------------------------------------------------------------- DropPath

def _toy_swin(remat):
    cfg = swin_cfg()
    p = cfg.MODEL.PARAMETERS
    p.NUM_FEATURES, p.NUM_UNROLLS, p.GRAD_CHECKPOINT = 16, 2, remat
    return cfg


def _toy_batch(cfg, seed=0):
    cfg.AUG_TRAIN.CROP_READOUT = 32
    pre = CinePreprocess(cfg, use_seed=True)
    k, m, t = make_cine_example(T=8, Y=40, X=40, C=4, E=2, seed=seed)
    return {key: np.asarray(v)[None]
            for key, v in pre(k, m, t, f"toy_{seed}").items()}


def test_drop_path_masks_replayed_under_remat():
    """The toy Swin solver in train mode, stochastic depth on (drop rates up
    to 0.2), with and without GRAD_CHECKPOINT on one dropout seed: the same
    loss and bitwise the same gradients. Without the replay the recompute
    draws other masks and the gradients differ by about 1e-3."""
    results = []
    for remat in (False, True):
        cfg = _toy_swin(remat)
        b = {k: torch.from_numpy(v) for k, v in _toy_batch(cfg).items()}
        model = build_solver(cfg, generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(5)
        set_dropout_generator(model, gen)
        assert any(isinstance(m, DropPath) and m.rate > 0
                   for m in model.modules())
        model.train()
        pred = model(b["kspace"], b["maps"], b["mask"], x0=b["init_image"])
        loss = torch.mean(torch.abs(pred - b["target"]))
        loss.backward()
        results.append((loss.item(), gen.get_state(),
                        {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}))
    (l0, s0, g0), (l1, s1, g1) = results
    assert l0 == l1 and set(g0) == set(g1) and len(g0) > 50
    assert torch.equal(s0, s1)      # the recompute left the generator as is
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_trainer_owns_the_dropout_generator():
    """The init generator seeds the weights only; the trainer's CPU
    generator, re-seeded from (SEED + 17, step), feeds every DropPath."""
    trainer = Trainer(_toy_swin(True), device="cpu")
    state = trainer.init_state()
    paths = [m for m in state.model.modules() if isinstance(m, DropPath)]
    assert paths and all(m.generator is trainer.dropout_generator
                         for m in paths)
    assert trainer.dropout_generator.device.type == "cpu"
    b = _toy_batch(trainer.cfg)
    losses = []
    for _ in range(2):          # the same step on the same weights
        state = trainer.init_state()
        losses.append(float(trainer.train_step(state, b)["Train/complex_l1"]))
    assert losses[0] == losses[1]


def test_training_after_serving_in_one_process():
    """Serving runs under torch.inference_mode; the constants it caches (the
    shift mask, the bias index, the DFT matrices) must still serve a later
    train step of the same shapes."""
    cfg = _toy_swin(True)
    b = _toy_batch(cfg, seed=1)
    params = {k: v.clone() for k, v in
              build_solver(cfg, generator=torch.Generator().manual_seed(0))
              .state_dict().items()}
    Reconstructor(cfg, params, device="cpu")(b)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(state_dict=params)
    loss = trainer.train_step(state, b)["Train/complex_l1"]
    assert torch.isfinite(loss) and state.step == 1


# ---------------------------------------------------------------- trajectory

def _jax_trainer(jcfg, batches):
    trainer = JaxTrainer(jcfg)
    trainer.set_steps_per_epoch(len(batches))
    state = trainer.init_state(batches[0])
    # stochastic depth off: the packages' dropout bits cannot match
    trainer.train_model = trainer.model
    trainer._build_steps()
    return trainer, state


def _jax_grads(trainer, params, batch):
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        pred = trainer._apply(p, b, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return trainer._metrics(pred, b, "Train")[
            f"Train/{trainer.loss_name}"]

    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jax.grad(loss_fn))(params))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


TRAJECTORY_CASES = {
    # example.yaml at toy widths, LOSS_WEIGHT on
    "RES": ("configs/basic/example.yaml", _res_overrides() + [
        "MODEL.RECON_LOSS.LOSS_WEIGHT", True], (8, 24, 24)),
    # with accumulation over 2 batches and clipping that triggers
    "RES-accum-clip": ("configs/basic/example.yaml", _res_overrides() + [
        "OPTIMIZER.GRAD_ACCUM_ITERS", 2, "OPTIMIZER.GRAD_CLIP_VAL", 0.05],
        (8, 24, 24)),
    # config_se.yaml at toy widths (RR 3), and its CBAM twin
    "SE": ("configs/config_se.yaml", _res_overrides() + [
        "MODEL.PARAMETERS.RR", 3], (8, 24, 24)),
    "CBAM": ("configs/config_se.yaml", _res_overrides() + [
        "MODEL.MODEL_TYPE", "CBAM", "MODEL.PARAMETERS.RR", 3], (8, 24, 24)),
    # config_swin.yaml narrowed as tests/test_torch_swin.py does
    "SWIN": ("configs/config_swin.yaml", [
        "MODEL.PARAMETERS.NUM_FEATURES", 16, "MODEL.PARAMETERS.NUM_UNROLLS", 2,
        "AUG_TRAIN.CROP_READOUT", 32, "OPTIMIZER.ADAM.LR", 0.001],
        (8, 40, 40)),
}


@pytest.mark.parametrize("case", TRAJECTORY_CASES)
def test_trajectory_matches_jax_trainer(case):
    """Converted weights, the same preprocessed batches, 3 train steps, with
    stochastic depth off on both sides: each step's loss to rel 1e-4, the
    first step's gradients per parameter to rel L2 1e-4 (float32 on both
    sides; the sums run in other orders)."""
    yaml, overrides, (T, Y, X) = TRAJECTORY_CASES[case]
    cfg = load_cfg(str(REPO / yaml), freeze=False)
    cfg.merge_from_list(overrides)
    jcfg = jax_load_cfg(str(REPO / yaml), freeze=False)
    jcfg.merge_from_list(overrides)
    pre = CinePreprocess(cfg, use_seed=True)
    batches = []
    for i in range(3):
        ex = pre(*make_cine_example(T=T, Y=Y, X=X, C=4, E=2, seed=i),
                 f"traj_{i}")
        batches.append({k: np.asarray(v)[None] for k, v in ex.items()})

    jtrainer, jstate = _jax_trainer(jcfg, batches)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    trainer = Trainer(cfg, device="cpu")
    trainer.set_steps_per_epoch(len(batches))
    state = trainer.init_state(state_dict=flax_to_torch(params))
    for m in state.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0

    jax_grads = flax_to_torch(_jax_grads(jtrainer, params, batches[0]))
    ours, theirs = [], []
    for step, b in enumerate(batches):
        ours.append(float(trainer.train_step(state, b)["Train/complex_l1"]))
        jstate, metrics = jtrainer._train_step(jstate, packing.pack(b))
        theirs.append(float(metrics["Train/complex_l1"]))
        if step == 0 and trainer.accum == 1:
            grads = {n: p.grad for n, p in state.model.named_parameters()
                     if p.grad is not None}
            assert set(grads) | {"step_size"} == set(jax_grads)
            for name, g in grads.items():
                assert _rel_l2(g.numpy(), jax_grads[name].numpy()) <= 1e-4, name
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert len(set(ours)) == 3


# ---------------------------------------------------------------- imports

def test_train_package_imports_no_jax_subprocess():
    code = (
        "import sys\n"
        "import dl_swin_gan_tpu_torch.train\n"
        "import dl_swin_gan_tpu_torch.train.__main__\n"
        "import dl_swin_gan_tpu_torch.train.train_lr\n"
        "import dl_swin_gan_tpu_torch.train.perceptual\n"
        "import dl_swin_gan_tpu_torch.scripts.train_swin_gan\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dl_swin_gan_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
