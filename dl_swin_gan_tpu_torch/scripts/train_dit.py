"""python -m dl_swin_gan_tpu_torch.scripts.train_dit --config-file <yaml>
[options] [KEY VALUE ...]: train a diffusion reconstruction model (DiT,
Latte or SwinDiff: MODEL.MODEL_TYPE picks the backbone; DDPM_X or DDPM_E),
such as

    python -m dl_swin_gan_tpu_torch.scripts.train_dit \\
        --config-file configs/config_dit.yaml --synthetic-data [--device cpu]

The counterpart of `scripts/train_DiT.py` beside the JAX package; the
options are `train/cli.py`'s (`--resume` restores the model, the optimizer
and the EMA)."""

import logging

from dl_swin_gan_tpu_torch.train.cli import run_training
from dl_swin_gan_tpu_torch.train.diffusion_trainer import DiffusionTrainer


def main(argv=None, description="Train DiT/Latte diffusion recon (torch "
                                "port)"):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    return run_training(
        lambda cfg, device: DiffusionTrainer(cfg, device=device),
        description, argv)


if __name__ == "__main__":
    main()
