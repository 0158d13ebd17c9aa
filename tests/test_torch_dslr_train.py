"""The torch port's DSLR training path against the JAX package:
CinePreprocess(lr_decom=True) bit for bit, the DSLRTrainer's loss
trajectory on converted weights, batches of two, and fit()."""

from pathlib import Path

import jax
import numpy as np
import torch

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.data.preprocess import CinePreprocess as JaxPreprocess
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.dslr_trainer import DSLRTrainer as JaxDSLRTrainer
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data import DataLoader, Hdf5Dataset
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, write_synthetic_dataset,
)
from dl_swin_gan_tpu_torch.train import DSLRTrainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- the trainer

_OVERRIDES = ["MODEL.PARAMETERS.NUM_UNROLLS", 2,
              "MODEL.PARAMETERS.NUM_RESBLOCKS", 1,
              "MODEL.PARAMETERS.NUM_FEATURES", 8,
              "MODEL.PARAMETERS.DSLR.BLOCK_SIZE", 8,
              "MODEL.PARAMETERS.DSLR.NUM_BASIS", 3,
              "MODEL.PARAMETERS.DSLR.NUM_CG_STEPS", 3,
              "AUG_TRAIN.CROP_READOUT", 16,
              "AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS", (4, 5),
              "AUG_VAL.UNDERSAMPLE.ACCELERATIONS", (4, 5),
              "OPTIMIZER.ADAM.LR", 0.001]


def _cfgs():
    cfg = load_cfg(str(REPO / "configs/config_dslr.yaml"), freeze=False)
    cfg.merge_from_list(_OVERRIDES)
    jcfg = jax_load_cfg(str(REPO / "configs/config_dslr.yaml"), freeze=False)
    jcfg.merge_from_list(_OVERRIDES)
    return cfg, jcfg


def test_preprocess_lr_decom_bit_exact_with_jax():
    """Seeded by the file name: every array, L_init and R_init included,
    equal bit for bit."""
    cfg, jcfg = _cfgs()
    k, m, t = make_cine_example(T=6, Y=24, X=32, C=4, E=2, seed=3)
    ours = CinePreprocess(cfg, use_seed=True, lr_decom=True)(k, m, t, "a.h5")
    theirs = JaxPreprocess(jcfg, use_seed=True, lr_decom=True)(k, m, t,
                                                              "a.h5")
    assert set(ours) == set(theirs) and {"L_init", "R_init"} <= set(ours)
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def _batches(cfg, n=3):
    pre = CinePreprocess(cfg, use_seed=True, lr_decom=True)
    out = []
    for i in range(n):
        ex = pre(*make_cine_example(T=6, Y=24, X=32, C=4, E=2, seed=i),
                 f"dslr_{i}")
        out.append({k: np.asarray(v)[None] for k, v in ex.items()})
    return out


def test_dslr_trainer_trajectory_matches_jax():
    """config_dslr.yaml narrowed, converted weights, the same preprocessed
    batches: 3 train steps, each step's loss to rel 1e-4."""
    cfg, jcfg = _cfgs()
    batches = _batches(cfg)
    jtrainer = JaxDSLRTrainer(jcfg)
    jtrainer.set_steps_per_epoch(len(batches))
    jstate = jtrainer.init_state(batches[0])
    jtrainer._build_steps()

    trainer = DSLRTrainer(cfg, device="cpu")
    trainer.set_steps_per_epoch(len(batches))
    state = trainer.init_state(state_dict=flax_to_torch(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    ours, theirs = [], []
    for b in batches:
        ours.append(float(trainer.train_step(state, b)["Train/complex_l1"]))
        jstate, metrics = jtrainer._train_step(jstate, packing.pack(b))
        theirs.append(float(metrics["Train/complex_l1"]))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert len(set(ours)) == 3


def test_dslr_trainer_batch_of_two_matches_per_example():
    """B=2 runs the solver per example and stacks the results."""
    cfg, _ = _cfgs()
    b0, b1 = _batches(cfg, 2)
    both = {k: np.concatenate([b0[k], b1[k]]) for k in b0}
    trainer = DSLRTrainer(cfg, device="cpu")
    state = trainer.init_state()
    _, pred = trainer.val_step(state, both)
    assert pred.shape == (2,) + b0["target"].shape[1:]
    for i, b in enumerate((b0, b1)):
        _, one = trainer.val_step(state, b)
        torch.testing.assert_close(pred[i:i + 1], one, rtol=0, atol=0)


def test_dslr_fit_with_validation(tmp_path):
    """fit() through Hdf5Dataset and the DataLoader with the lr_decom
    preprocess: steps, a falling loss, validation metrics, a checkpoint."""
    import json

    for split, seed in (("train", 0), ("val", 100)):
        write_synthetic_dataset(str(tmp_path / split), num_files=2 if
                                split == "train" else 1, slices=1, T=6, Y=24,
                                X=32, C=4, E=2, seed=seed)
    cfg, _ = _cfgs()
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 1
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    state = DSLRTrainer(cfg, device="cpu").fit(
        str(tmp_path / "train"), str(tmp_path / "val"), max_epochs=2)
    assert state.step == 4
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r["Train/complex_l1"] for r in recs if "Train/complex_l1" in r]
    assert len(train) == 4 and np.isfinite(train).all()
    assert any("Validate/complex_l1" in r for r in recs)
    val = Hdf5Dataset(str(tmp_path / "val"), DSLRTrainer(
        cfg, device="cpu").make_preprocess(aug_node=cfg.AUG_VAL,
                                           use_seed=True))
    assert {"L_init", "R_init"} <= set(next(iter(DataLoader(val, 1))))
