"""One quality-table row: the reference evaluation protocol (12x VDkt
re-undersampling at the parity seed, SSIM/RMSE/PSNR against the
fully-sampled adjoint) over the held-out exams of the quality set.

Counterpart of `scripts/quality_row.py` beside the JAX package (kinds
`unrolled`, `diffusion`, `dslr` and `zerofilled`). It takes the quality
set's test split in memory (`data.synthetic.quality_split`, the files
`datasets/make_quality_set.sh` writes), so it needs neither h5py nor
pyyaml: the config is `utils.headline.quality_cfg(--dtype, --model)`
(`configs/quality/resnet.yaml` or `resnet_bf16.yaml`; `se.yaml`,
`cbam.yaml`, `swin.yaml` or `swingan.yaml` with --model se, cbam, swin or
swingan; `latte2.yaml`, `dit.yaml` or `dit_ema.yaml` with --kind
diffusion and --model latte2, dit or dit_ema; `dslr.yaml`, or `dslr_fast.yaml` with --model dslr_fast,
with --kind dslr) with KEY VALUE overrides. Training batches are built on
the device (DATALOADER.DEVICE_PIPELINE, as the YAMLs set it); swingan
trains through GANTrainer, the diffusion rows through DiffusionTrainer, and
those are scored by conditional sampling (`--sample-steps`, 100 by default,
from the raw weights unless --use-ema); the DSLR rows train through
DSLRTrainer (L0 and R0 from the block SVD on the device) and are scored by
LRReconstructor (`scripts/reconstruct_lr.py`'s steps). `--draw-seed N`
seeds the training loader's crops, flips and masks from (N, k) for its
k-th example, so that a row can be repeated; without it they are unseeded,
as in the JAX package. The train and validate files are named by the
paths the JAX rows' `Hdf5Dataset` gave them (`fit_data`), since the seeded
validation draws read the name. Under --out it writes `<exam>_1accel.im` and
`<exam>_<R>accel.im` CFLs and `eval_<R>accel.csv` (scripts/evaluate.py).

    # train the row's network first (the config's 40 epochs on the train
    # and validate splits, checkpoints under <out>/train), then score it
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind unrolled \\
        --dtype bfloat16 --train --out runs/torch_quality/resbf16
    # the SE row at the JAX row's 40 epochs (se.yaml says 24)
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind unrolled \\
        --model se --train --max-epochs 40 --out runs/torch_quality/se
    # the SwinGAN row at the adversarial weight of the JAX row's retrain
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind unrolled \\
        --model swingan --train --max-epochs 40 \\
        --out runs/torch_quality/swingan MODEL.GAN.ADV_WEIGHT 0.003
    # the Latte-2u row: 8k steps (250 epochs of the 32 training slices)
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind diffusion \\
        --model latte2 --train --max-epochs 250 --batch-size 4 \\
        --out runs/torch_quality/latte2
    # the DSLR row: 157 epochs of the 32 training slices, the JAX row's 5k
    # steps
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind dslr \
        --train --max-epochs 157 --out runs/torch_quality/dslr
    # the DiT-EMA row: 634 epochs, the JAX row's 20288 steps; then its
    # EMA weights from the same checkpoints
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind diffusion \\
        --model dit_ema --train --max-epochs 634 --out runs/torch_quality/ditema
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind diffusion \\
        --model dit_ema --ckpt runs/torch_quality/ditema/train/checkpoints \\
        --use-ema --out runs/torch_quality/ditema_ema
    # score a checkpoint of the port's trainer
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind unrolled \\
        --ckpt runs/x/checkpoints --out runs/x/recon
    python -m dl_swin_gan_tpu_torch.scripts.quality_row --kind zerofilled

It runs on the GPU unless --device cpu is given. --files, --slices and
--shape cut the quality set (for tests at a reduced size).
"""

import argparse
import logging
import os
import time

from dl_swin_gan_tpu_torch.data.synthetic import as_h5_files, quality_split
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    accel_tag, load_checkpoint_params, make_reconstructor, reconstruct_exam,
)
from dl_swin_gan_tpu_torch.scripts.evaluate import main as evaluate_main
from dl_swin_gan_tpu_torch.utils.device import resolve_device
from dl_swin_gan_tpu_torch.utils.headline import quality_cfg

logger = logging.getLogger(__name__)


def _cut(args) -> dict:
    """The quality set's geometry overrides from --slices and --shape."""
    cut = {}
    if args.slices:
        cut["slices"] = args.slices
    if args.shape:
        cut.update(zip(("T", "Y", "X", "C"),
                       (int(v) for v in args.shape.split(","))))
    return cut


def fit_data(cfg, args):
    """The in-memory train and validate splits, each file named by the path
    the H5 run's `Hdf5Dataset` gave it under DATASET.TRAIN and DATASET.VAL
    (`data.synthetic.as_h5_files`): the seeded validation draws read that
    name, so the row validates on the JAX rows' masks and crops."""
    cut = _cut(args)
    return (as_h5_files(quality_split("train", args.files, **cut),
                        cfg.DATASET.TRAIN[0]),
            as_h5_files(quality_split("validate", args.files, **cut),
                        cfg.DATASET.VAL[0]))


def train(cfg, args, device):
    """Fit cfg on the in-memory train and validate splits; returns the
    checkpoint directory and the final step."""
    from dl_swin_gan_tpu_torch.train import (
        DiffusionTrainer, DSLRTrainer, GANTrainer, Trainer,
    )

    t0 = time.perf_counter()
    train_files, val_files = fit_data(cfg, args)
    logger.info("quality set: %d train and %d validate files in %.1f s",
                len(train_files), len(val_files), time.perf_counter() - t0)
    kw = dict(device=device, draw_seed=args.draw_seed)
    if args.kind == "diffusion":
        trainer = DiffusionTrainer(cfg, sample_steps=args.sample_steps, **kw)
    elif args.kind == "dslr":
        trainer = DSLRTrainer(cfg, **kw)
    else:
        trainer = (GANTrainer if args.model == "swingan" else Trainer)(cfg, **kw)
    state = trainer.fit(max_epochs=args.max_epochs, train_data=train_files,
                        val_data=val_files)
    return os.path.join(cfg.OUTPUT_DIR, "checkpoints"), state.step


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", required=True,
                        choices=["unrolled", "diffusion", "dslr",
                                 "zerofilled"])
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="CONV_BLOCK.DTYPE (bfloat16: resnet_bf16.yaml, "
                             "dit_bf16.yaml, or the model's YAML with a bf16 "
                             "trunk)")
    parser.add_argument("--model", default=None,
                        choices=["res", "se", "cbam", "swin", "swingan",
                                 "latte2", "dit", "dit_ema", "dslr",
                                 "dslr_fast"],
                        help="the network: resnet.yaml (the default), "
                             "se.yaml, cbam.yaml, swin.yaml or swingan.yaml; "
                             "latte2.yaml, dit.yaml or dit_ema.yaml (--kind "
                             "diffusion); "
                             "dslr.yaml (the default of --kind dslr) or "
                             "dslr_fast.yaml")
    parser.add_argument("--train", action="store_true",
                        help="train the network first (kind unrolled)")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint directory of the port's trainer")
    parser.add_argument("--out", default=None,
                        help="output directory (default runs/torch_quality/"
                             "<kind>[_<dtype>])")
    parser.add_argument("--acceleration", type=float, default=12)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--sample-steps", type=int, default=100,
                        help="diffusion sampling steps")
    parser.add_argument("--use-ema", action="store_true",
                        help="score the checkpoint's EMA weights")
    parser.add_argument("--max-epochs", type=int, default=None,
                        help="training epochs (default OPTIMIZER.MAX_EPOCHS)")
    parser.add_argument("--draw-seed", type=int, default=None,
                        help="seed the training draws (crops, flips, masks) "
                             "from (N, k); unseeded when not given")
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when not given")
    parser.add_argument("--files", type=int, default=None,
                        help="keep the first N files of each split")
    parser.add_argument("--slices", type=int, default=None,
                        help="slices per file (default 4)")
    parser.add_argument("--shape", default=None,
                        help="T,Y,X,C of each slice (default 18,156,96,8)")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = parser.parse_args(argv)
    if args.model is None:
        args.model = "dslr" if args.kind == "dslr" else "res"
    family = {"latte2": "diffusion", "dit": "diffusion",
              "dit_ema": "diffusion", "dslr": "dslr",
              "dslr_fast": "dslr"}.get(args.model, "unrolled")
    if args.kind != "zerofilled" and args.kind != family:
        parser.error(f"--kind {args.kind} does not go with --model "
                     f"{args.model}")
    if args.kind != "zerofilled" and not (args.ckpt or args.train):
        parser.error(f"--kind {args.kind} needs --ckpt or --train")
    if args.kind == "zerofilled" and (args.ckpt or args.train):
        parser.error("--kind zerofilled takes no --ckpt and no --train")

    device = resolve_device(args.device)
    out = args.out or os.path.join(
        "runs", "torch_quality",
        args.kind + ("" if args.kind == "zerofilled" else
                     "_" + args.dtype if args.model in ("res", "dslr") else
                     f"_{args.model}_{args.dtype}"))
    cfg = quality_cfg(args.dtype, args.model)
    cfg.OUTPUT_DIR = os.path.join(out, "train")
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    ckpt, step = args.ckpt, None
    if args.train:
        ckpt, step = train(cfg, args, device)
    os.makedirs(out, exist_ok=True)
    accel = args.acceleration
    tag = accel_tag(accel)
    recon = None
    if args.kind != "zerofilled":
        params = load_checkpoint_params(ckpt, step=step, use_ema=args.use_ema)
        recon = make_reconstructor(cfg, params, device, args.sample_steps)

    t0 = time.perf_counter()
    exams = quality_split("test", args.files, **_cut(args))
    logger.info("quality set: %d test files in %.1f s", len(exams),
                time.perf_counter() - t0)
    for name, kspace, maps, _ in exams:
        # the fully-sampled adjoint reference, then the row at R
        for a, rc in ((1, None), (accel, recon)):
            reconstruct_exam(name, kspace, maps, out, cfg, rc, a,
                             args.batch_size)
        logger.info("%s: %d slices written at 1x and %sx", name, len(kspace),
                    tag)
    return evaluate_main(["--recon-directory", out, "--acceleration",
                          str(accel)])


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    raise SystemExit(main() or 0)
