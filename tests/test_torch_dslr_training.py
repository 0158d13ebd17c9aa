"""The DSLR quality row's training through both packages (ROADMAP Queue 3,
the DSLR row's train-step probe). Serving was held alike before
(tests/test_torch_dslr_serving.py); this holds training alike: the port's
`DSLRTrainer` and the JAX package's from one init (the JAX init converted
by `flax_to_torch`), on the same batches, which the port's device pipeline
builds on the CPU from the quality set's slices with seeded draws and
lr_decom (each step's crop, flips, VDkt mask and block SVD), and which
both trainers are fed. Float32 on both sides. Each package's `validate`
then scores the same validation batches, built by the host
`CinePreprocess(aug_node=AUG_VAL, use_seed=True)` as `fit` builds them.

The test: 10 steps at toy widths (2 unrolls of 1 resblock of 8 features,
3 CG steps, 8x8 blocks of 3 basis vectors) on the quality set cut to
8x32x32 slices of 4 coils; each step's loss within rel 1e-4 of the JAX
DSLRTrainer's, and both validations' complex_l1 within rel 1e-4.

Run as a script it trains both for longer at configs/quality/dslr.yaml's
widths (5 unrolls of 2 resblocks of 64 features, 10 CG steps, 16x16 blocks
of 8 basis vectors) on a cut geometry, and prints the per-step losses'
largest relative difference and both validations:

    python -m tests.test_torch_dslr_training [--steps N] [--features F]
"""

import argparse
from pathlib import Path

import jax
import numpy as np
import torch

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.dslr_trainer import DSLRTrainer as JaxDSLRTrainer
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data import DataLoader, InMemoryDataset
from dl_swin_gan_tpu_torch.data.synthetic import quality_split
from dl_swin_gan_tpu_torch.train import DSLRTrainer
from tests.test_torch_se_training import pipeline_batches

REPO = Path(__file__).resolve().parent.parent
YAML = "configs/quality/dslr.yaml"
TOY = dict(features=8, unrolls=2, resblocks=1, cg=3, block=8, basis=3,
           crop=24, geometry=dict(slices=2, T=8, Y=32, X=32, C=4))
LOSS_RTOL = 1e-4

torch.set_num_threads(1)


def cfgs(features, unrolls, resblocks, cg, block, basis, crop):
    """configs/quality/dslr.yaml in both packages at these widths and
    crop."""
    overrides = ["MODEL.PARAMETERS.NUM_FEATURES", features,
                 "MODEL.PARAMETERS.NUM_UNROLLS", unrolls,
                 "MODEL.PARAMETERS.NUM_RESBLOCKS", resblocks,
                 "MODEL.PARAMETERS.DSLR.NUM_CG_STEPS", cg,
                 "MODEL.PARAMETERS.DSLR.BLOCK_SIZE", block,
                 "MODEL.PARAMETERS.DSLR.NUM_BASIS", basis,
                 "AUG_TRAIN.CROP_READOUT", crop, "AUG_VAL.CROP_READOUT", crop]
    out = []
    for load in (load_cfg, jax_load_cfg):
        cfg = load(str(REPO / YAML), freeze=False)
        cfg.merge_from_list(list(overrides))
        out.append(cfg)
    return out


def train_both(cfg, jcfg, batches, log_every=0):
    """Both DSLR trainers from the JAX init through `batches`: (port trainer
    and state, JAX trainer and state, per-step losses of each)."""
    jtrainer = JaxDSLRTrainer(jcfg)
    jtrainer.set_steps_per_epoch(len(batches))
    jstate = jtrainer.init_state(batches[0])
    jtrainer._build_steps()
    trainer = DSLRTrainer(cfg, device="cpu")
    trainer.set_steps_per_epoch(len(batches))
    state = trainer.init_state(state_dict=flax_to_torch(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    ours, theirs = [], []
    for step, b in enumerate(batches):
        ours.append(float(trainer.train_step(state, b)["Train/complex_l1"]))
        jstate, metrics = jtrainer._train_step(jstate, packing.pack(b))
        theirs.append(float(metrics["Train/complex_l1"]))
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}: loss port {ours[-1]:.6f} jax "
                  f"{theirs[-1]:.6f}", flush=True)
    return (trainer, state), (jtrainer, jstate), ours, theirs


def val_batches(trainer, files):
    """The validation batches `fit` builds: the AUG_VAL preprocess seeded
    by the file's name, batch VAL_BATCH_SIZE, in order."""
    cfg = trainer.cfg
    data = InMemoryDataset(files, trainer.make_preprocess(
        aug_node=cfg.AUG_VAL, use_seed=True))
    return list(DataLoader(data, batch_size=cfg.DATALOADER.VAL_BATCH_SIZE,
                           shuffle=False, drop_last=False))


def validate_both(port, jax_side, files):
    """complex_l1 of each package's `validate` on the same batches."""
    (trainer, state), (jtrainer, jstate) = port, jax_side
    batches = val_batches(trainer, files)
    ours = trainer.validate(state, batches)["Validate/complex_l1"]
    theirs = jtrainer.validate(jstate, batches)["Validate/complex_l1"]
    return ours, theirs


def test_dslr_training_steps_match_jax_trainer():
    cfg, jcfg = cfgs(*(TOY[k] for k in ("features", "unrolls", "resblocks",
                                         "cg", "block", "basis", "crop")))
    files = quality_split("train", 1, **TOY["geometry"])
    batches = pipeline_batches(cfg, files, 10, lr_decom=True)
    port, jax_side, ours, theirs = train_both(cfg, jcfg, batches)
    np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL)
    assert len(set(ours)) == 10
    val = quality_split("validate", 1, **TOY["geometry"])
    v_ours, v_theirs = validate_both(port, jax_side, val)
    np.testing.assert_allclose(v_ours, v_theirs, rtol=LOSS_RTOL)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--features", type=int, default=64)
    parser.add_argument("--unrolls", type=int, default=5)
    parser.add_argument("--files", type=int, default=2)
    parser.add_argument("--shape", type=int, nargs=3, default=(12, 64, 48),
                        metavar=("T", "Y", "X"))
    parser.add_argument("--crop", type=int, default=32)
    parser.add_argument("--threads", type=int, default=8)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    T, Y, X = args.shape
    geometry = dict(slices=2, T=T, Y=Y, X=X, C=4)
    cfg, jcfg = cfgs(args.features, args.unrolls, 2, 10, 16, 8, args.crop)
    files = quality_split("train", args.files, **geometry)
    batches = pipeline_batches(cfg, files, args.steps, lr_decom=True)
    port, jax_side, ours, theirs = train_both(cfg, jcfg, batches,
                                              log_every=25)
    rel = np.abs(np.subtract(ours, theirs)) / np.abs(theirs)
    print(f"{args.steps} steps: per-step loss rel diff max {rel.max():.3e} "
          f"(first 10 steps {rel[:10].max():.3e}, last 10 "
          f"{rel[-10:].max():.3e}); mean loss of the last 25 steps port "
          f"{np.mean(ours[-25:]):.6f} jax {np.mean(theirs[-25:]):.6f}")
    val = quality_split("validate", 1, **geometry)
    v_ours, v_theirs = validate_both(port, jax_side, val)
    print(f"validation complex_l1 (each package's validate): port "
          f"{v_ours:.6f} jax {v_theirs:.6f}")


if __name__ == "__main__":
    main()
