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
8x36x32 slices of the row's 8 coils, cropped to a readout of 24 as the row
crops 96 to 64; each step's loss within rel 1e-4 of the JAX
DSLRTrainer's, and both validations' complex_l1 within rel 1e-4 on the
batches `fit` builds from the row's files (`row_val_batches`).

Run as a script it trains both for longer at configs/quality/dslr.yaml's
widths (5 unrolls of 2 resblocks of 64 features, 10 CG steps, 16x16 blocks
of 8 basis vectors) on a cut geometry, and prints the per-step losses'
largest relative difference and both validations:

    python -m tests.test_torch_dslr_training [--steps N] [--features F]

With --full it runs configs/quality/dslr.yaml as it stands on the quality
set with no cut, as `tests/test_torch_se_training.py --full` runs se.yaml:
one DSLRTrainer step from the converted init held against the JAX
package's (its nets are 2D and 1D, so the JAX 3D-conv lowerings do not
apply), both validations on the row's validation batches at the init and
after a trajectory of as many steps as --minutes per package allow (at
least 50):

    python -m tests.test_torch_dslr_training --full [--minutes 90]

and with --one-step the one-step check alone, against the port's float64
step.
"""

import argparse

import numpy as np
import torch

from dl_swin_gan_tpu.train.dslr_trainer import DSLRTrainer as JaxDSLRTrainer
from dl_swin_gan_tpu_torch.data.synthetic import quality_split
from dl_swin_gan_tpu_torch.train import DSLRTrainer
from tests.test_torch_se_training import (
    full_probe, load_both, pipeline_batches, print_trajectory,
    row_val_batches, train_both, validate_both,
)

YAML = "configs/quality/dslr.yaml"
TOY = dict(features=8, unrolls=2, resblocks=1, cg=3, block=8, basis=3,
           crop=24, geometry=dict(slices=2, T=8, Y=36, X=32, C=8))
LOSS_RTOL = 1e-4

torch.set_num_threads(1)


def cfgs(features, unrolls, resblocks, cg, block, basis, crop):
    """configs/quality/dslr.yaml in both packages at these widths and
    crop."""
    return load_both(YAML, [
        "MODEL.PARAMETERS.NUM_FEATURES", features,
        "MODEL.PARAMETERS.NUM_UNROLLS", unrolls,
        "MODEL.PARAMETERS.NUM_RESBLOCKS", resblocks,
        "MODEL.PARAMETERS.DSLR.NUM_CG_STEPS", cg,
        "MODEL.PARAMETERS.DSLR.BLOCK_SIZE", block,
        "MODEL.PARAMETERS.DSLR.NUM_BASIS", basis,
        "AUG_TRAIN.CROP_READOUT", crop, "AUG_VAL.CROP_READOUT", crop])


def train_both_dslr(cfg, jcfg, batches, log_every=0):
    return train_both(cfg, jcfg, batches, log_every, DSLRTrainer,
                      JaxDSLRTrainer)


def test_dslr_training_steps_match_jax_trainer():
    cfg, jcfg = cfgs(*(TOY[k] for k in ("features", "unrolls", "resblocks",
                                         "cg", "block", "basis", "crop")))
    files = quality_split("train", 1, **TOY["geometry"])
    batches = pipeline_batches(cfg, files, 10, lr_decom=True)
    port, jax_side, ours, theirs = train_both_dslr(cfg, jcfg, batches)
    np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL)
    assert len(set(ours)) == 10
    val = quality_split("validate", 1, **TOY["geometry"])
    v_ours, v_theirs = validate_both(port, jax_side,
                                     row_val_batches(port[0], cfg, val))
    np.testing.assert_allclose(v_ours, v_theirs, rtol=LOSS_RTOL)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", action="store_true",
                        help="dslr.yaml as it stands at the quality set's "
                             "geometry (the other options but --minutes and "
                             "--threads do not apply)")
    parser.add_argument("--minutes", type=float, default=90,
                        help="--full: CPU minutes of training a package")
    parser.add_argument("--one-step", action="store_true",
                        help="--full: only the one-step check, with the "
                             "port's float64 step as the reference")
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
    if args.full:
        cfg, jcfg = load_both(YAML)
        full_probe(cfg, jcfg, DSLRTrainer, JaxDSLRTrainer, args.minutes,
                   lr_decom=True, lowerings=("xla",), serve=False,
                   one_step=args.one_step)
        return
    T, Y, X = args.shape
    geometry = dict(slices=2, T=T, Y=Y, X=X, C=4)
    cfg, jcfg = cfgs(args.features, args.unrolls, 2, 10, 16, 8, args.crop)
    files = quality_split("train", args.files, **geometry)
    batches = pipeline_batches(cfg, files, args.steps, lr_decom=True)
    port, jax_side, ours, theirs = train_both_dslr(cfg, jcfg, batches,
                                                   log_every=25)
    print_trajectory(ours, theirs)
    val = quality_split("validate", 1, **geometry)
    v_ours, v_theirs = validate_both(port, jax_side,
                                     row_val_batches(port[0], cfg, val))
    print(f"validation complex_l1 (each package's validate): port "
          f"{v_ours:.6f} jax {v_theirs:.6f}")


if __name__ == "__main__":
    main()
