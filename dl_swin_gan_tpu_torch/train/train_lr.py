"""python -m dl_swin_gan_tpu_torch.train.train_lr --config-file <yaml>
[options] [KEY VALUE ...]: train a DSLR low-rank model (META_ARCHITECTURE
dslr-cg-v1, dslr-cg-v2, dslr-cg-jacobi, modslr-v1 or modslr-v2), such as

    python -m dl_swin_gan_tpu_torch.train.train_lr \\
        --config-file configs/config_dslr.yaml --synthetic-data [--device cpu]

The counterpart of the JAX package's `scripts/train_lr.py`; the options are
`train/cli.py`'s."""

import logging

from dl_swin_gan_tpu_torch.train.cli import run_training
from dl_swin_gan_tpu_torch.train.dslr_trainer import DSLRTrainer


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    return run_training(lambda cfg, device: DSLRTrainer(cfg, device=device),
                        "Train a DSLR low-rank model (torch port)", argv)


if __name__ == "__main__":
    main()
