"""python -m dl_swin_gan_tpu_torch.train --config-file <yaml> [options]
[KEY VALUE ...]: train an unrolled model (see train/cli.py)."""

import logging

from dl_swin_gan_tpu_torch.train.cli import run_training
from dl_swin_gan_tpu_torch.train.trainer import Trainer


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    return run_training(lambda cfg, device: Trainer(cfg, device=device),
                        "Train an unrolled reconstruction model (torch port)",
                        argv)


if __name__ == "__main__":
    main()
