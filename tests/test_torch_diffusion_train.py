"""The port's DiffusionTrainer against the JAX package's, and its entry
points, on the CPU at toy widths: a 3-step trajectory from converted
weights on the same preprocessed batches, the JAX package's t and noise fed
to the port, each step's loss to rel 1e-4, the parameters and the EMA after
the third step to rel L2 1e-3 (Adam divides by small second moments); fit
through the device pipeline with a resume; the diffusion quality configs
against their YAMLs; the training, H5 serving and quality-row command
lines."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.diffusion_trainer import (
    DiffusionTrainer as JaxDiffusionTrainer,
)
from dl_swin_gan_tpu.train.train_state import TrainState as JaxTrainState
from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, synthetic_files,
)
from dl_swin_gan_tpu_torch.train import CheckpointManager, DiffusionTrainer
from dl_swin_gan_tpu_torch.utils.headline import quality_cfg
from tests.test_torch_diffusion import (
    _rel_l2, jax_solver_and_params, toy_cfg,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
E, C, T, Y, X = 2, 3, 6, 20, 12
DECAY = 0.5      # an EMA that moves visibly in 3 steps


def _train_cfg(get, model_type, meta):
    cfg = toy_cfg(get, model_type, meta)
    cfg.MODEL.PARAMETERS.FIX_STEP_SIZE = True
    cfg.MODEL.PARAMETERS.SLWIN_INIT = False
    cfg.OPTIMIZER.ADAM.LR = 1e-3
    cfg.AUG_TRAIN.CROP_READOUT = 0
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (3, 4)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.SEED = 5
    return cfg


def _batches(cfg, n=3):
    pre = CinePreprocess(cfg, use_seed=True)
    out = []
    for i in range(n):
        ex = pre(*make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=i),
                 f"dtraj_{i}")
        out.append({k: np.asarray(v)[None] for k, v in ex.items()})
    return out


def _jax_draws(seed, step, target_shape):
    """The JAX DiffusionTrainer's t and noise of a train step."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 7), step)
    k_t, k_noise, _ = jax.random.split(key, 3)
    b = target_shape[0]
    t = jax.random.randint(k_t, (b,), 0, 1000)
    shape = (b, 2 * target_shape[1]) + tuple(target_shape[2:])
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("model_type,meta", [("LATTE", "DDPM_X"),
                                             ("DIT", "DDPM_E")])
def test_trajectory_matches_jax_diffusion_trainer(model_type, meta):
    jcfg = _train_cfg(jax_get_cfg, model_type, meta)
    batches = _batches(_train_cfg(get_cfg, model_type, meta))
    jtrainer = JaxDiffusionTrainer(jcfg, ema_decay=DECAY, sample_steps=3)
    first = batches[0]
    _, params = jax_solver_and_params(jcfg, first["target"], first["maps"],
                                      first["mask"], seed=3)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=jtrainer.tx.init(params),
                           ema_params=params)
    jtrainer._build_steps()

    trainer = DiffusionTrainer(_train_cfg(get_cfg, model_type, meta),
                               device="cpu", ema_decay=DECAY, sample_steps=3)
    state = trainer.init_state(state_dict=flax_to_torch(params))
    ours, theirs = [], []
    for step, b in enumerate(batches):
        t, noise = _jax_draws(jcfg.SEED, step, b["target"].shape)
        ours.append(float(trainer.train_step(state, b, t=t,
                                             noise=noise)["Train MSE"]))
        jstate, metrics = jtrainer._train_step(
            jstate, packing.pack(jtrainer.prepare_batch(b)))
        theirs.append(float(metrics["Train MSE"]))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert len(set(ours)) == 3 and state.step == 3
    jparams = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params))
    jema = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                jstate.ema_params))
    moved = 0
    for name, p in state.model.named_parameters():
        keep = _with_gradient(name, p)
        assert _rel_l2(p.detach().numpy()[keep],
                       jparams[name].numpy()[keep]) <= 1e-3, name
        assert _rel_l2(state.ema[name].numpy()[keep],
                       jema[name].numpy()[keep]) <= 1e-3, name
        moved += not torch.equal(p.detach(), flax_to_torch(params)[name])
    assert moved > 0


def _with_gradient(name, p):
    """The elements of a parameter that take a gradient. The key third of an
    attention's qkv bias takes none in exact arithmetic (a constant added to
    a query's logits leaves its softmax as it is), so its gradient is
    roundoff in either package, which Adam scales up to full steps."""
    keep = np.ones(tuple(p.shape), bool)
    if name.endswith("attn.qkv.bias"):
        n = p.shape[0] // 3
        keep[n:2 * n] = False
    return keep


def test_trainer_draws_are_seeded_by_step():
    """Without given draws a step's t and noise come from (SEED + 7, step):
    two trainers agree, and two steps differ."""
    cfg = _train_cfg(get_cfg, "LATTE", "DDPM_X")
    target = torch.zeros(1, E, T, Y, X, dtype=torch.complex64)
    a = DiffusionTrainer(cfg, device="cpu").draws(12, 0, target)
    b = DiffusionTrainer(cfg, device="cpu").draws(12, 0, target)
    c = DiffusionTrainer(cfg, device="cpu").draws(12, 1, target)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert a[1].shape == (1, 2 * E, T, Y, X) and 0 <= int(a[0]) < 1000


def test_fit_through_device_pipeline_and_resume(tmp_path):
    """DiffusionTrainer.fit on records held in memory through the device
    pipeline (its diffusion batches), validation with the sampling SSIM, a
    checkpoint holding the EMA, and a resume that continues the step
    count."""
    cfg = _train_cfg(get_cfg, "LATTE", "DDPM_X")
    cfg.DATALOADER.DEVICE_PIPELINE = True
    cfg.AUG_TRAIN.CROP_READOUT = 8
    cfg.AUG_VAL.CROP_READOUT = 8
    cfg.AUG_VAL.UNDERSAMPLE.ACCELERATIONS = (3, 4)
    cfg.EVAL.RUN_EVERY_N_EPOCHS = 1
    cfg.EVAL.RECON_SSIM_EVERY_N_EPOCHS = 2
    cfg.OUTPUT_DIR = str(tmp_path)
    files = list(synthetic_files(2, seed=0, slices=1, T=T, Y=Y, X=X, C=C,
                                 E=E))
    trainer = DiffusionTrainer(cfg, device="cpu", sample_steps=2)
    state = trainer.fit(max_epochs=2, train_data=files, val_data=files[:1])
    assert state.step == 4 and set(state.ema) == {
        n for n, _ in state.model.named_parameters()}
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    assert mgr.latest_step() == 4
    payload = mgr.restore()
    assert payload["ema"] and "Validate recon SSIM (EMA)" in (
        (tmp_path / "metrics.jsonl").read_text())
    again = DiffusionTrainer(cfg, device="cpu", sample_steps=2).fit(
        max_epochs=3, train_data=files, val_data=files[:1], resume=True)
    assert again.step == 6


@pytest.mark.parametrize("model,yaml", [("latte2", "latte2.yaml"),
                                        ("dit", "dit.yaml")])
def test_diffusion_quality_cfg_matches_yaml(model, yaml):
    ours = quality_cfg(model=model)
    ref = load_cfg(str(REPO / "configs/quality" / yaml))
    for node in ref:
        assert ours[node] == ref[node], node
    assert set(ours) == set(ref)


def test_dit_bf16_quality_cfg_matches_yaml():
    """quality_cfg("bfloat16", "dit") is configs/quality/dit_bf16.yaml."""
    ours = quality_cfg("bfloat16", "dit")
    ref = load_cfg(str(REPO / "configs/quality/dit_bf16.yaml"))
    for node in ref:
        assert ours[node] == ref[node], node
    assert set(ours) == set(ref)


def test_train_dit_cli_on_synthetic_data(tmp_path):
    """`scripts.train_dit` with configs/config_latte.yaml cut to toy widths
    on the CPU: trains, checkpoints, serves the checkpoint from H5 through
    `scripts.reconstruct_h5 --model Latte --sample-steps 2`."""
    pytest.importorskip("h5py")
    pytest.importorskip("yaml")
    from dl_swin_gan_tpu_torch.scripts import reconstruct_h5, train_dit

    out = tmp_path / "run"
    cut = ["MODEL.PARAMETERS.NUM_LAYERS", "2",
           "MODEL.PARAMETERS.NUM_FEATURES", "24",
           "MODEL.PARAMETERS.NUM_HEADS", "2",
           "MODEL.PARAMETERS.NUM_UNROLLS", "1", "MODEL.STRATEGY", "none",
           "DATALOADER.NUM_WORKERS", "0", "DATALOADER.DEVICE_PIPELINE",
           "False", "EVAL.RUN_EVERY_N_EPOCHS", "1", "OUTPUT_DIR", str(out)]
    train_dit.main(["--config-file", str(REPO / "configs/config_latte.yaml"),
                    "--synthetic-data", "--max-epochs", "1", "--device",
                    "cpu"] + cut)
    ckpt = out / "checkpoints"
    assert CheckpointManager(str(ckpt)).latest_step() == 8
    h5 = sorted((out / "data" / "val").glob("*.h5"))[0]
    written = reconstruct_h5.main([
        "--config-file", str(REPO / "configs/config_dit.yaml"),
        "--model", "Latte", "--ckpt", str(ckpt), "--file", str(h5),
        "--out-directory", str(tmp_path / "recon"), "--acceleration", "4",
        "--sample-steps", "2", "--device", "cpu"] + cut[:10])
    assert os.path.exists(written + ".cfl")


def test_quality_row_diffusion_kind(tmp_path):
    """--kind diffusion --model latte2 --train on a cut of the quality set:
    trains through the device pipeline, samples the test exam, writes the
    CSV; a diffusion model under --kind unrolled is refused."""
    from dl_swin_gan_tpu_torch.scripts import quality_row

    args = ["--files", "1", "--slices", "1", "--shape", "6,48,24,2",
            "--device", "cpu", "--out", str(tmp_path), "--sample-steps", "2"]
    cut = ["MODEL.PARAMETERS.NUM_LAYERS", "2",
           "MODEL.PARAMETERS.NUM_FEATURES", "24",
           "MODEL.PARAMETERS.NUM_HEADS", "2",
           "AUG_TRAIN.CROP_READOUT", "8", "AUG_VAL.CROP_READOUT", "8",
           "EVAL.RUN_EVERY_N_EPOCHS", "1"]
    quality_row.main(["--kind", "diffusion", "--model", "latte2", "--train",
                      "--max-epochs", "1"] + args + cut)
    assert (tmp_path / "eval_12accel.csv").exists()
    with pytest.raises(SystemExit):
        quality_row.main(["--kind", "unrolled", "--model", "latte2",
                          "--train"] + args)
