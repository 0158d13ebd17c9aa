"""One quality-table row: the reference evaluation protocol (12x VDkt
re-undersampling at the parity seed, SSIM/RMSE/PSNR against the
fully-sampled adjoint) over the held-out exams of the quality set.

Counterpart of `scripts/quality_row.py` beside the JAX package (kinds
`unrolled` and `zerofilled`). It takes the quality set's test split in
memory (`data.synthetic.quality_split`, the files
`datasets/make_quality_set.sh` writes), so it needs neither h5py nor
pyyaml: the config is `utils.headline.quality_cfg(--dtype, --model)`
(`configs/quality/resnet.yaml` or `resnet_bf16.yaml`; `se.yaml`,
`cbam.yaml`, `swin.yaml` or `swingan.yaml` with --model se, cbam, swin or
swingan) with KEY VALUE overrides. Training batches are built on the device
(DATALOADER.DEVICE_PIPELINE, as the YAMLs set it); swingan trains through
GANTrainer. Under --out it writes `<exam>_1accel.im` and
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

from dl_swin_gan_tpu_torch.data.synthetic import quality_split
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    Reconstructor, accel_tag, accel_transform, load_checkpoint_params,
    reconstruct_examples, write_image_cfl,
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


def train(cfg, args, device):
    """Fit cfg on the in-memory train and validate splits; returns the
    checkpoint directory and the final step."""
    from dl_swin_gan_tpu_torch.train import GANTrainer, Trainer

    cut = _cut(args)
    t0 = time.perf_counter()
    train_files = quality_split("train", args.files, **cut)
    val_files = quality_split("validate", args.files, **cut)
    logger.info("quality set: %d train and %d validate files in %.1f s",
                len(train_files), len(val_files), time.perf_counter() - t0)
    trainer_cls = GANTrainer if args.model == "swingan" else Trainer
    trainer = trainer_cls(cfg, device=device)
    state = trainer.fit(max_epochs=args.max_epochs, train_data=train_files,
                        val_data=val_files)
    return os.path.join(cfg.OUTPUT_DIR, "checkpoints"), state.step


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", required=True,
                        choices=["unrolled", "zerofilled"])
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="CONV_BLOCK.DTYPE: resnet.yaml or resnet_bf16.yaml")
    parser.add_argument("--model", default="res",
                        choices=["res", "se", "cbam", "swin", "swingan"],
                        help="the network: resnet.yaml, se.yaml, cbam.yaml, "
                             "swin.yaml or swingan.yaml")
    parser.add_argument("--train", action="store_true",
                        help="train the network first (kind unrolled)")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint directory of the port's trainer")
    parser.add_argument("--out", default=None,
                        help="output directory (default runs/torch_quality/"
                             "<kind>[_<dtype>])")
    parser.add_argument("--acceleration", type=float, default=12)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--max-epochs", type=int, default=None,
                        help="training epochs (default OPTIMIZER.MAX_EPOCHS)")
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
    if args.kind == "unrolled" and not (args.ckpt or args.train):
        parser.error("--kind unrolled needs --ckpt or --train")
    if args.kind == "zerofilled" and (args.ckpt or args.train):
        parser.error("--kind zerofilled takes no --ckpt and no --train")

    device = resolve_device(args.device)
    out = args.out or os.path.join(
        "runs", "torch_quality",
        args.kind + ("" if args.kind != "unrolled" else
                     "_" + args.dtype if args.model == "res" else
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
    if args.kind == "unrolled":
        params = load_checkpoint_params(ckpt, step=step)
        recon = Reconstructor(cfg, params, device)

    t0 = time.perf_counter()
    exams = quality_split("test", args.files, **_cut(args))
    logger.info("quality set: %d test files in %.1f s", len(exams),
                time.perf_counter() - t0)
    reference, resample = accel_transform(cfg, 1), accel_transform(cfg, accel)
    for name, kspace, maps, _ in exams:
        # the fully-sampled adjoint reference, then the row at R
        for a, transform, rc in ((1, reference, None), (accel, resample, recon)):
            examples = [transform(kspace[s], maps[s])
                        for s in range(len(kspace))]
            images = reconstruct_examples(examples, rc, args.batch_size)
            write_image_cfl(os.path.join(out, f"{name}_{accel_tag(a)}accel.im"),
                            images)
        logger.info("%s: %d slices written at 1x and %sx", name, len(kspace),
                    tag)
    return evaluate_main(["--recon-directory", out, "--acceleration",
                          str(accel)])


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    raise SystemExit(main() or 0)
