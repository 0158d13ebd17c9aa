"""The SE quality row's training through both packages (ROADMAP Queue 3,
the SE row's probe 4). Probe 3 (tests/test_torch_se_serving.py) showed that
both packages serve the same weights alike; this holds their training
alike: the port's `Trainer` and the JAX package's from one init (the JAX
init converted by `flax_to_torch`), on the same batches, which the port's
device pipeline builds on the CPU from the quality set's slices with
seeded draws (each step's crop, flips and VDkt mask from its own seed) and
which both trainers are fed. Float32 on both sides.

The test: 10 steps at toy widths (2 unrolls of 1 SE resblock of 16
features, RR 4) on the quality set cut to 8x36x32 slices of the row's 8
coils, cropped to a readout of 24 as the row crops 96 to 64; each step's
loss within rel 1e-4 of the JAX Trainer's (the sums run in other orders;
the trajectory tests of tests/test_torch_train.py hold 3 steps to the
same limit).

Run as a script it trains both for longer at the SE row's widths (5
unrolls of 1 resblock of 96 features, RR 16) on a cut geometry and prints
the per-step losses' largest relative difference, both validation losses,
and the 12x SSIM and PSNR of both packages' weights served through the
port's Reconstructor:

    python -m tests.test_torch_se_training [--steps N] [--features F]

With --full it runs configs/quality/se.yaml as it stands on the quality
set with no cut (`QUALITY_SET`: 8 coils, 18x156x96 slices, the 32 training
examples, readout crop 64). It holds one step from the converted init,
the forward output, the loss and every parameter's gradient, against the
JAX package's, once per JAX 3D-conv lowering (`DL_SWIN_GAN_CONV3D` xla,
and tapc, the one the JAX rows trained through on the TPU). It validates
both on the row's validation batches (`row_val_batches`) at the init,
times a step of each, trains both for as many steps as --minutes per
package allow (at least 50), validates again and serves both weight sets:

    python -m tests.test_torch_se_training --full [--minutes 90]

--full --one-step runs the one-step check alone, with the port's step in
float64 beside it (`port_one_step_f64`), which says how far each float32
side's roundoff goes.
"""

import argparse
import copy
import itertools
import os
import random
import time
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import torch

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.trainer import Trainer as JaxTrainer
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data import DataLoader, InMemoryDataset
from dl_swin_gan_tpu_torch.data.device_pipeline import DevicePipeline
from dl_swin_gan_tpu_torch.data.synthetic import as_h5_files, quality_split
from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_volumes
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    Reconstructor, accel_transform, batched,
)
from dl_swin_gan_tpu_torch.train import Trainer
from dl_swin_gan_tpu_torch.train.losses import select_loss

REPO = Path(__file__).resolve().parent.parent
YAML = "configs/quality/se.yaml"
TOY = dict(features=16, unrolls=2, rr=4, crop=24,
           geometry=dict(slices=2, T=8, Y=36, X=32, C=8))
LOSS_RTOL = 1e-4
# the one-step check at the row's geometry: loss, and each parameter's
# gradient in rel L2
GRAD_RTOL = 1e-3

torch.set_num_threads(1)


def load_both(yaml, overrides=()):
    """`yaml` in both packages with KEY VALUE `overrides`: (port, JAX)."""
    out = []
    for load in (load_cfg, jax_load_cfg):
        cfg = load(str(REPO / yaml), freeze=False)
        cfg.merge_from_list(list(overrides))
        out.append(cfg)
    return out


def cfgs(features, unrolls, rr, crop):
    """configs/quality/se.yaml in both packages at these widths and crop."""
    return load_both(YAML, ["MODEL.PARAMETERS.NUM_FEATURES", features,
                            "MODEL.PARAMETERS.NUM_UNROLLS", unrolls,
                            "MODEL.PARAMETERS.RR", rr,
                            "AUG_TRAIN.CROP_READOUT", crop])


def iter_pipeline_batches(cfg, files, steps=None, seed=0, lr_decom=False):
    """Training batches (numpy) of the port's device pipeline on the CPU,
    `steps` of them or without end: the examples in a seeded order,
    reshuffled each epoch as the loader does, each step's draws seeded by
    the step; with lr_decom, the DSLR factors L_init and R_init too."""
    pipe = DevicePipeline(cfg, use_seed=True, device="cpu",
                          lr_decom=lr_decom)
    examples = [(name, kspace[s], maps[s]) for name, kspace, maps, _ in files
                for s in range(len(kspace))]
    step = 0
    for epoch in itertools.count():
        order = list(range(len(examples)))
        random.Random(seed + epoch).shuffle(order)
        for i in order:
            if steps is not None and step == steps:
                return
            name, kspace, maps = examples[i]
            params = pipe.draw_params(f"{name}/{i}/{step}", kspace.shape)
            batch = pipe.build(pipe.upload_raw(kspace, maps), params)
            yield {k: v.numpy() for k, v in batch.items()}
            step += 1


def pipeline_batches(cfg, files, steps, seed=0, lr_decom=False):
    """The first `steps` batches of `iter_pipeline_batches`, as a list."""
    return list(iter_pipeline_batches(cfg, files, steps, seed, lr_decom))


def init_both(trainer_cls, jax_trainer_cls, cfg, jcfg, sample_batch,
              steps_per_epoch):
    """Both trainers, the port's from the JAX init converted by
    `flax_to_torch`: (port trainer and state, JAX trainer and state)."""
    jtrainer = jax_trainer_cls(jcfg)
    jtrainer.set_steps_per_epoch(steps_per_epoch)
    jstate = jtrainer.init_state(sample_batch)
    jtrainer._build_steps()
    trainer = trainer_cls(cfg, device="cpu")
    trainer.set_steps_per_epoch(steps_per_epoch)
    state = trainer.init_state(state_dict=flax_to_torch(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    return (trainer, state), (jtrainer, jstate)


def step_both(port, jax_side, batch):
    """One train step of each package on `batch`: (port loss, JAX loss, port
    seconds, JAX seconds); `jax_side` (a list) gets the stepped JAX
    state."""
    (trainer, state), (jtrainer, jstate) = port, jax_side
    t0 = time.perf_counter()
    ours = float(trainer.train_step(state, batch)["Train/complex_l1"])
    t1 = time.perf_counter()
    jstate, metrics = jtrainer._train_step(jstate, packing.pack(batch))
    theirs = float(metrics["Train/complex_l1"])
    jax_side[1] = jstate
    return ours, theirs, t1 - t0, time.perf_counter() - t1


def train_both(cfg, jcfg, batches, log_every=0, trainer_cls=Trainer,
               jax_trainer_cls=JaxTrainer):
    """Both trainers from the JAX init through `batches`: (port trainer and
    state, JAX trainer and state, per-step losses of each)."""
    port, jax_side = init_both(trainer_cls, jax_trainer_cls, cfg, jcfg,
                               batches[0], len(batches))
    jax_side = list(jax_side)
    ours, theirs = [], []
    for step, b in enumerate(batches):
        o, t, _, _ = step_both(port, jax_side, b)
        ours.append(o)
        theirs.append(t)
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}: loss port {o:.6f} jax {t:.6f}",
                  flush=True)
    return port, tuple(jax_side), ours, theirs


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _complex_np(x):
    """A prediction as a complex numpy array, whichever package made it."""
    x = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    return x if np.iscomplexobj(x) else x[..., 0] + 1j * x[..., 1]


def _port_step(trainer, model, b):
    """Forward and backward of `model` on the device batch `b`: (output,
    loss, per-parameter gradients, and the gradient with respect to the
    output of each gated block's conv1, by block name)."""
    taps, handles = {}, []

    def tap(name):
        def hook(module, inputs, out):
            out.register_hook(
                lambda g: taps.__setitem__(name, g.detach().clone()))
        return hook

    for name, m in model.named_modules():
        if getattr(m, "channel_gate", None) is not None:
            handles.append(m.conv1.register_forward_hook(tap(name)))
    model.zero_grad(set_to_none=True)
    pred = trainer._apply(model, b)
    loss = select_loss(trainer._metrics(pred, b, "Train"), trainer.loss_name,
                       "Train")
    loss.backward()
    for h in handles:
        h.remove()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return _complex_np(pred), float(loss.detach()), grads, taps


def port_one_step(trainer, state, batch):
    """The port's forward output, loss, per-parameter gradients and gated
    conv1 output gradients (`_port_step`) of one training step on `batch`,
    the weights left as they were."""
    return _port_step(trainer, state.model.train(),
                      trainer._to_device(batch))


def jax_one_step(jtrainer, params, batch, conv3d):
    """The JAX package's forward output, loss and gradients (converted to
    the port's names) of one training step on `batch`, traced with
    DL_SWIN_GAN_CONV3D=`conv3d` (read by `models/layers.py conv_nd` at
    trace time; a fresh jit traces anew)."""
    import jax.numpy as jnp

    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        pred = jtrainer._apply(p, b, train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})
        metrics = jtrainer._metrics(pred, b, "Train")
        return metrics[f"Train/{jtrainer.loss_name}"], pred

    before = os.environ.get("DL_SWIN_GAN_CONV3D")
    os.environ["DL_SWIN_GAN_CONV3D"] = conv3d
    try:
        (loss, pred), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        loss = float(loss)
    finally:
        if before is None:
            del os.environ["DL_SWIN_GAN_CONV3D"]
        else:
            os.environ["DL_SWIN_GAN_CONV3D"] = before
    grads = {k: v.numpy() for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    return _complex_np(pred), loss, grads


def port_one_step_f64(trainer, state, batch):
    """`port_one_step` in float64, the reference against which both float32
    sides' roundoff is read: the weights and the batch widened, the SENSE
    normal op through its FFT chain and the block-LLR one through the
    operator chain it fuses (the kernels' wrappers take complex64 only)."""
    from dl_swin_gan_tpu_torch.ops import sense
    from dl_swin_gan_tpu_torch.solvers import dslr

    def chain_block_normal(block_op, maps, mask):
        A = sense.SenseOp(maps, mask)

        def one(blocks):
            return block_op(A.normal(block_op(blocks, adjoint=True)))

        def f(blocks, blocks2=None):
            return one(blocks) if blocks2 is None else (one(blocks),
                                                        one(blocks2))
        return f

    model = copy.deepcopy(state.model).double().train()
    b = {k: v.to(torch.complex128 if v.is_complex() else torch.float64)
         for k, v in trainer._to_device(batch).items()}
    with mock.patch.object(sense, "_normal_fusable", lambda *a: False), \
            mock.patch.object(dslr, "make_fused_block_normal",
                              chain_block_normal):
        return _port_step(trainer, model, b)


def print_bias_bisect(grads, taps, ref):
    """For each gated block, where the port's float32 conv1 bias gradient
    leaves the float64 one: the gradient with respect to conv1's output,
    that gradient summed by `torch.sum` (the bias gradient's definition),
    and the bias gradient the conv's backward returned, each in rel L2
    against float64."""
    for name, g in taps.items():
        g64 = ref[3][name]
        exact = g64.sum((0, 2, 3, 4)).numpy()
        print(f"  {name}.conv1 (float32 against float64): output gradient "
              f"{rel_l2(g.double().numpy(), g64.numpy()):.3e}; its torch.sum "
              f"{rel_l2(g.sum((0, 2, 3, 4)).numpy(), exact):.3e}; the conv "
              f"backward's bias gradient "
              f"{rel_l2(grads[name + '.conv1.conv.bias'], exact):.3e}")


def one_step_report(port, jax_side, batch, lowerings=("xla", "tapc"),
                    f64=False):
    """Prints one training step of the port against the JAX package's, from
    the same weights on `batch`, once per JAX conv lowering: the forward
    output's rel L2, the loss's rel diff (limit LOSS_RTOL) and each
    parameter's gradient rel L2 (limit GRAD_RTOL), the largest first; with
    `f64`, also each side's distance from the port's float64 step."""
    (trainer, state), (jtrainer, jstate) = port, jax_side
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    t0 = time.perf_counter()
    pred, loss, grads, taps = port_one_step(trainer, state, batch)
    print(f"one step, port: loss {loss:.8f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    ref = port_one_step_f64(trainer, state, batch) if f64 else None
    if f64:
        print(f"one step, port in float64: loss {ref[1]:.10f}; port float32 "
              f"output rel L2 {rel_l2(pred, ref[0]):.3e}, loss rel diff "
              f"{abs(loss - ref[1]) / abs(ref[1]):.3e}", flush=True)
        print_bias_bisect(grads, taps, ref)
    for mode in lowerings:
        t0 = time.perf_counter()
        jpred, jloss, jgrads = jax_one_step(jtrainer, params, batch, mode)
        missing = set(grads) - set(jgrads)
        assert not missing, missing
        rels = {n: rel_l2(g, jgrads[n]) for n, g in grads.items()}
        out_rel = rel_l2(pred, jpred)
        loss_rel = abs(loss - jloss) / abs(jloss)
        worst = sorted(rels.items(), key=lambda kv: -kv[1])
        held = loss_rel <= LOSS_RTOL and worst[0][1] <= GRAD_RTOL
        print(f"one step, jax {mode} ({time.perf_counter() - t0:.1f} s): "
              f"loss {jloss:.8f}, rel diff {loss_rel:.3e} (limit "
              f"{LOSS_RTOL:g}); output rel L2 {out_rel:.3e}; gradient rel "
              f"L2 over {len(rels)} parameters: max {worst[0][1]:.3e} "
              f"({worst[0][0]}), median {np.median(list(rels.values())):.3e}"
              f" (limit {GRAD_RTOL:g}): {'holds' if held else 'EXCEEDS'}",
              flush=True)
        if f64:
            print(f"  jax {mode} against float64: output rel L2 "
                  f"{rel_l2(jpred, ref[0]):.3e}, loss rel diff "
                  f"{abs(jloss - ref[1]) / abs(ref[1]):.3e}")
        for name, r in worst[:5]:
            far = (f" (from float64: port "
                   f"{rel_l2(grads[name], ref[2][name]):.3e}, jax "
                   f"{rel_l2(jgrads[name], ref[2][name]):.3e})"
                   if f64 else "")
            print(f"  {name}: {r:.3e}{far}")


def row_val_batches(trainer, cfg, files=None):
    """The quality row's validation batches, as `fit` builds them from
    `quality_row.fit_data`'s files: the AUG_VAL preprocess seeded by each
    file's name, the names being the H5 paths under DATASET.VAL, batch
    VAL_BATCH_SIZE, in order. `files` defaults to the whole validate
    split."""
    files = quality_split("validate") if files is None else files
    data = InMemoryDataset(as_h5_files(files, cfg.DATASET.VAL[0]),
                           trainer.make_preprocess(aug_node=cfg.AUG_VAL,
                                                   use_seed=True))
    return list(DataLoader(data, batch_size=cfg.DATALOADER.VAL_BATCH_SIZE,
                           shuffle=False, drop_last=False))


def validate_both(port, jax_side, batches):
    """complex_l1 of each package's `validate` on the same batches."""
    (trainer, state), (jtrainer, jstate) = port, jax_side
    ours = trainer.validate(state, batches)["Validate/complex_l1"]
    theirs = jtrainer.validate(jstate, batches)["Validate/complex_l1"]
    return ours, theirs


def full_trajectory(port, jax_side, batches, minutes, min_steps=50,
                    log_every=10):
    """Trains both from where they stand on the `batches` iterator: the
    first two steps timed (the second is each package's step time, the
    first holds the JAX compile), then as many more as `minutes` per
    package allow, and at least `min_steps` in all. Returns the per-step
    losses (port, JAX) and the JAX side (trainer, state)."""
    jax_side = list(jax_side)
    ours, theirs = [], []
    steps = min_steps
    for step, b in enumerate(batches):
        if step == steps:
            break
        o, t, port_s, jax_s = step_both(port, jax_side, b)
        ours.append(o)
        theirs.append(t)
        if step == 0:
            first = port_s, jax_s
        if step == 1:
            steps = max(min_steps, int(minutes * 60 / max(port_s, jax_s)))
            print(f"step time: port {port_s:.2f} s, jax {jax_s:.2f} s "
                  f"(first step {first[0]:.2f} / {first[1]:.2f} s with the "
                  f"compile): {steps} steps in {minutes:g} minutes a "
                  "package", flush=True)
        if (step + 1) % log_every == 0:
            print(f"step {step + 1}: loss port {o:.6f} jax {t:.6f}",
                  flush=True)
    return ours, theirs, tuple(jax_side)


def print_trajectory(ours, theirs):
    rel = np.abs(np.subtract(ours, theirs)) / np.abs(theirs)
    n = len(ours)
    print(f"{n} steps: per-step loss rel diff max {rel.max():.3e} at step "
          f"{int(rel.argmax()) + 1} (first 10 steps {rel[:10].max():.3e}, "
          f"last 10 {rel[-10:].max():.3e}); mean loss of the last 25 steps "
          f"port {np.mean(ours[-25:]):.6f} jax {np.mean(theirs[-25:]):.6f}",
          flush=True)
    return rel


def test_se_training_steps_match_jax_trainer():
    cfg, jcfg = cfgs(TOY["features"], TOY["unrolls"], TOY["rr"],
                     TOY["crop"])
    files = quality_split("train", 1, **TOY["geometry"])
    batches = pipeline_batches(cfg, files, 10)
    _, _, ours, theirs = train_both(cfg, jcfg, batches)
    np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL)
    assert len(set(ours)) == 10


def serve_both(cfg, weights, files):
    """Prints the 12x SSIM, PSNR and RMSE of each weight set in `weights`
    ({tag: port state dict}) served by the port's Reconstructor on the
    slices of the first of `files`, against their 1x adjoint."""
    serve_cfg = cfg.clone()
    serve_cfg.freeze()
    _, kspace, maps, _ = files[0]
    resample, full = accel_transform(serve_cfg, 12), accel_transform(
        serve_cfg, 1)
    examples = [resample(kspace[s], maps[s]) for s in range(len(kspace))]
    ref = np.stack([full(kspace[s], maps[s])["init_image"]
                    * full(kspace[s], maps[s])["scale"]
                    for s in range(len(kspace))]).astype(np.complex64)
    for tag, w in weights.items():
        recon = Reconstructor(serve_cfg, w, device="cpu")
        images = np.concatenate([recon(b) for b in batched(examples, 1)])
        m = evaluate_volumes(ref, images)
        print(f"{tag} weights served by the port at 12x: "
              + ", ".join(f"{k} {float(np.mean(v)):.5f}"
                          for k, v in m.items()), flush=True)


def both_weights(port, jax_side):
    """{"port": ..., "jax": ...}: each package's weights as a port state
    dict."""
    (_, state), (_, jstate) = port, jax_side
    return {"port": {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()},
            "jax": flax_to_torch(jax.tree_util.tree_map(
                np.asarray, jstate.params))}


def full_probe(cfg, jcfg, trainer_cls, jax_trainer_cls, minutes, lr_decom,
               lowerings=("xla", "tapc"), serve=True, one_step=False):
    """The --full run of a row's config at the quality set's own geometry:
    the one-step check, both validations at the init, the trajectory, both
    validations after it, and (with `serve`) both weight sets served; with
    `one_step`, the one-step check against the float64 step alone."""
    t0 = time.perf_counter()
    files = quality_split("train")
    batches = iter_pipeline_batches(cfg, files, lr_decom=lr_decom)
    first = next(batches)
    print(f"quality set: {len(files)} train files, batch "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in first.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    n_examples = sum(len(k) for _, k, _, _ in files)
    port, jax_side = init_both(trainer_cls, jax_trainer_cls, cfg, jcfg,
                               first, n_examples)
    one_step_report(port, jax_side, first, lowerings, f64=one_step)
    if one_step:
        return
    val = row_val_batches(port[0], cfg)
    v = validate_both(port, jax_side, val)
    print(f"validation complex_l1 at the init ({len(val)} batches of the "
          f"row): port {v[0]:.6f} jax {v[1]:.6f} (rel diff "
          f"{abs(v[0] - v[1]) / abs(v[1]):.3e})", flush=True)
    ours, theirs, jax_side = full_trajectory(
        port, jax_side, itertools.chain([first], batches), minutes)
    print_trajectory(ours, theirs)
    v = validate_both(port, jax_side, val)
    print(f"validation complex_l1 after {len(ours)} steps: port {v[0]:.6f} "
          f"jax {v[1]:.6f} (rel diff {abs(v[0] - v[1]) / abs(v[1]):.3e}); "
          f"training complex_l1 of the last 25 steps port "
          f"{np.mean(ours[-25:]):.6f} jax {np.mean(theirs[-25:]):.6f}",
          flush=True)
    if serve:
        serve_both(cfg, both_weights(port, jax_side),
                   quality_split("validate", 1))
    print(f"done in {time.perf_counter() - t0:.0f} s", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", action="store_true",
                        help="se.yaml as it stands at the quality set's "
                             "geometry (the other options but --minutes and "
                             "--threads do not apply)")
    parser.add_argument("--minutes", type=float, default=90,
                        help="--full: CPU minutes of training a package")
    parser.add_argument("--one-step", action="store_true",
                        help="--full: only the one-step check, with the "
                             "port's float64 step as the reference")
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--features", type=int, default=96)
    parser.add_argument("--unrolls", type=int, default=5)
    parser.add_argument("--files", type=int, default=2)
    parser.add_argument("--shape", type=int, nargs=3, default=(12, 64, 48),
                        metavar=("T", "Y", "X"))
    parser.add_argument("--crop", type=int, default=32)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.full:
        cfg, jcfg = load_both(YAML)
        full_probe(cfg, jcfg, Trainer, JaxTrainer, args.minutes,
                   lr_decom=False, one_step=args.one_step)
        return
    T, Y, X = args.shape
    geometry = dict(slices=2, T=T, Y=Y, X=X, C=4)
    cfg, jcfg = cfgs(args.features, args.unrolls, 16, args.crop)
    files = quality_split("train", args.files, **geometry)
    batches = pipeline_batches(cfg, files, args.steps)
    port, jax_side, ours, theirs = train_both(cfg, jcfg, batches,
                                              log_every=25)
    print_trajectory(ours, theirs)

    val_files = quality_split("validate", 1, **geometry)
    val = pipeline_batches(cfg, val_files, len(val_files[0][1]), seed=1)
    (trainer, state), (jtrainer, jstate) = port, jax_side
    port_val = [float(trainer.val_step(state, b)[0]["Validate/complex_l1"])
                for b in val]
    jax_val = [float(jtrainer._val_step(jstate.params, packing.pack(b))[0][
        "Validate/complex_l1"]) for b in val]
    print(f"validation complex_l1: port {np.mean(port_val):.6f} jax "
          f"{np.mean(jax_val):.6f}")
    serve_both(cfg, both_weights(port, jax_side), val_files)


if __name__ == "__main__":
    main()
