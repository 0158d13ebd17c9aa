"""The SE quality row's training through both packages (ROADMAP Queue 3,
the SE row's probe 4). Probe 3 (tests/test_torch_se_serving.py) showed that
both packages serve the same weights alike; this holds their training
alike: the port's `Trainer` and the JAX package's from one init (the JAX
init converted by `flax_to_torch`), on the same batches, which the port's
device pipeline builds on the CPU from the quality set's slices with
seeded draws (each step's crop, flips and VDkt mask from its own seed) and
which both trainers are fed. Float32 on both sides.

The test: 10 steps at toy widths (2 unrolls of 1 SE resblock of 16
features, RR 4) on the quality set cut to 8x32x32 slices of 4 coils; each
step's loss within rel 1e-4 of the JAX Trainer's (the sums run in other
orders; the trajectory tests of tests/test_torch_train.py hold 3 steps to
the same limit).

Run as a script it trains both for longer at the SE row's widths (5
unrolls of 1 resblock of 96 features, RR 16) on a cut geometry and prints
the per-step losses' largest relative difference, both validation losses,
and the 12x SSIM and PSNR of both packages' weights served through the
port's Reconstructor:

    python -m tests.test_torch_se_training [--steps N] [--features F]
"""

import argparse
import random
from pathlib import Path

import jax
import numpy as np
import torch

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.trainer import Trainer as JaxTrainer
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data.device_pipeline import DevicePipeline
from dl_swin_gan_tpu_torch.data.synthetic import quality_split
from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_volumes
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    Reconstructor, accel_transform, batched,
)
from dl_swin_gan_tpu_torch.train import Trainer

REPO = Path(__file__).resolve().parent.parent
YAML = "configs/quality/se.yaml"
TOY = dict(features=16, unrolls=2, rr=4, crop=24,
           geometry=dict(slices=2, T=8, Y=32, X=32, C=4))
LOSS_RTOL = 1e-4

torch.set_num_threads(1)


def cfgs(features, unrolls, rr, crop):
    """configs/quality/se.yaml in both packages at these widths and crop."""
    overrides = ["MODEL.PARAMETERS.NUM_FEATURES", features,
                 "MODEL.PARAMETERS.NUM_UNROLLS", unrolls,
                 "MODEL.PARAMETERS.RR", rr, "AUG_TRAIN.CROP_READOUT", crop]
    out = []
    for load in (load_cfg, jax_load_cfg):
        cfg = load(str(REPO / YAML), freeze=False)
        cfg.merge_from_list(list(overrides))
        out.append(cfg)
    return out


def pipeline_batches(cfg, files, steps, seed=0, lr_decom=False):
    """`steps` training batches (numpy) of the port's device pipeline on the
    CPU: the examples in a seeded order, reshuffled each epoch as the
    loader does, each step's draws seeded by the step; with lr_decom, the
    DSLR factors L_init and R_init too."""
    pipe = DevicePipeline(cfg, use_seed=True, device="cpu",
                          lr_decom=lr_decom)
    examples = [(name, kspace[s], maps[s]) for name, kspace, maps, _ in files
                for s in range(len(kspace))]
    out = []
    epoch = 0
    while len(out) < steps:
        order = list(range(len(examples)))
        random.Random(seed + epoch).shuffle(order)
        epoch += 1
        for i in order[:steps - len(out)]:
            name, kspace, maps = examples[i]
            params = pipe.draw_params(f"{name}/{i}/{len(out)}", kspace.shape)
            batch = pipe.build(pipe.upload_raw(kspace, maps), params)
            out.append({k: v.numpy() for k, v in batch.items()})
    return out


def train_both(cfg, jcfg, batches, log_every=0):
    """Both trainers from the JAX init through `batches`: (port trainer and
    state, JAX trainer and state, per-step losses of each)."""
    jtrainer = JaxTrainer(jcfg)
    jtrainer.set_steps_per_epoch(len(batches))
    jstate = jtrainer.init_state(batches[0])
    jtrainer._build_steps()
    trainer = Trainer(cfg, device="cpu")
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


def test_se_training_steps_match_jax_trainer():
    cfg, jcfg = cfgs(TOY["features"], TOY["unrolls"], TOY["rr"],
                     TOY["crop"])
    files = quality_split("train", 1, **TOY["geometry"])
    batches = pipeline_batches(cfg, files, 10)
    _, _, ours, theirs = train_both(cfg, jcfg, batches)
    np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL)
    assert len(set(ours)) == 10


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--features", type=int, default=96)
    parser.add_argument("--unrolls", type=int, default=5)
    parser.add_argument("--files", type=int, default=2)
    parser.add_argument("--shape", type=int, nargs=3, default=(12, 64, 48),
                        metavar=("T", "Y", "X"))
    parser.add_argument("--crop", type=int, default=32)
    args = parser.parse_args(argv)
    torch.set_num_threads(8)
    T, Y, X = args.shape
    geometry = dict(slices=2, T=T, Y=Y, X=X, C=4)
    cfg, jcfg = cfgs(args.features, args.unrolls, 16, args.crop)
    files = quality_split("train", args.files, **geometry)
    batches = pipeline_batches(cfg, files, args.steps)
    (trainer, state), (jtrainer, jstate), ours, theirs = train_both(
        cfg, jcfg, batches, log_every=25)
    rel = np.abs(np.subtract(ours, theirs)) / np.abs(theirs)
    print(f"{args.steps} steps: per-step loss rel diff max {rel.max():.3e} "
          f"(first 10 steps {rel[:10].max():.3e}, last 10 "
          f"{rel[-10:].max():.3e}); mean loss of the last 25 steps port "
          f"{np.mean(ours[-25:]):.6f} jax {np.mean(theirs[-25:]):.6f}")

    val_files = quality_split("validate", 1, **geometry)
    val = pipeline_batches(cfg, val_files, len(val_files[0][1]), seed=1)
    port_val = [float(trainer.val_step(state, b)[0]["Validate/complex_l1"])
                for b in val]
    jax_val = [float(jtrainer._val_step(jstate.params, packing.pack(b))[0][
        "Validate/complex_l1"]) for b in val]
    print(f"validation complex_l1: port {np.mean(port_val):.6f} jax "
          f"{np.mean(jax_val):.6f}")

    serve_cfg = cfg.clone()
    serve_cfg.freeze()
    _, kspace, maps, _ = val_files[0]
    resample, full = accel_transform(serve_cfg, 12), accel_transform(
        serve_cfg, 1)
    examples = [resample(kspace[s], maps[s]) for s in range(len(kspace))]
    ref = np.stack([full(kspace[s], maps[s])["init_image"]
                    * full(kspace[s], maps[s])["scale"]
                    for s in range(len(kspace))]).astype(np.complex64)
    weights = {"port": {k: v.detach().cpu() for k, v in
                        state.model.state_dict().items()},
               "jax": flax_to_torch(jax.tree_util.tree_map(
                   np.asarray, jstate.params))}
    for tag, w in weights.items():
        recon = Reconstructor(serve_cfg, w, device="cpu")
        images = np.concatenate([recon(b) for b in batched(examples, 1)])
        m = evaluate_volumes(ref, images)
        print(f"{tag} weights served by the port at 12x: "
              + ", ".join(f"{k} {float(np.mean(v)):.5f}"
                          for k, v in m.items()))


if __name__ == "__main__":
    main()
