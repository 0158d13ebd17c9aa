"""python -m dl_swin_gan_tpu_torch.scripts.train_swin_gan --config-file <yaml>
[options] [KEY VALUE ...]: train the SwinGAN (an unrolled Swin generator and
a 3D PatchGAN discriminator, LSGAN), such as

    python -m dl_swin_gan_tpu_torch.scripts.train_swin_gan \\
        --config-file configs/config_swingan.yaml --synthetic-data [--device cpu]

The counterpart of `scripts/train_swin_gan.py` beside the JAX package; the
options are `train/cli.py`'s (`--resume` restores both models and both
optimizers)."""

import logging

from dl_swin_gan_tpu_torch.train.cli import run_training
from dl_swin_gan_tpu_torch.train.gan_trainer import GANTrainer


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    return run_training(lambda cfg, device: GANTrainer(cfg, device=device),
                        "Train SwinGAN adversarial recon (torch port)", argv)


if __name__ == "__main__":
    main()
