"""The training command line.

Counterpart of `train/cli.py` in the JAX package: argument parsing, seeding,
the synthetic-data bootstrap and the freeze discipline in one helper, so
later trainer families cannot drift apart. Run it as

    python -m dl_swin_gan_tpu_torch.train --config-file configs/config_swin.yaml \\
        [--synthetic-data] [--resume] [--max-epochs N] [--device cpu] [KEY VALUE ...]

It trains on the GPU unless `--device cpu` is given. Under torchrun,

    torchrun --nproc-per-node N -m dl_swin_gan_tpu_torch.train ...

each rank joins the process group from the environment (NCCL on
cuda:LOCAL_RANK; gloo with `--device cpu`) and the trainer trains over the
mesh PARALLEL.* and MODEL.STRATEGY describe (`train/trainer.py`). The YAML
needs pyyaml and the datasets h5py.
"""

import argparse
import os
import random

import numpy as np
import torch
import torch.distributed as dist

from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.parallel.mesh import (
    init_torchrun, is_rank0, launched_by_torchrun,
)


def _ensure_synthetic(directory: str, **kwargs) -> None:
    """Write a synthetic split only when it is missing or empty, checked per
    split: a run killed between the train and val writes heals the val
    split on the rerun."""
    from dl_swin_gan_tpu_torch.data.synthetic import write_synthetic_dataset

    if not os.path.isdir(directory) or not os.listdir(directory):
        write_synthetic_dataset(directory, **kwargs)


def run_training(make_trainer, description: str, argv=None):
    """Parse the training command line, build the trainer, fit.

    make_trainer: (cfg, device) -> trainer with .fit(train_dir, val_dir,
    max_epochs=..., resume=...).
    """
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--synthetic-data", action="store_true",
                        help="generate a synthetic cine dataset under OUTPUT_DIR")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU when not given")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    # OUTPUT_DIR may come from the YAML or from a KEY VALUE override
    cfg = load_cfg(args.config_file, require_output_dir=False, freeze=False)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if not cfg.OUTPUT_DIR:
        parser.error("OUTPUT_DIR must be set (in the YAML or as a "
                     "'OUTPUT_DIR <path>' override)")

    random.seed(cfg.SEED)
    np.random.seed(cfg.SEED)
    torch.manual_seed(cfg.SEED)
    device = args.device
    if launched_by_torchrun():
        device = init_torchrun(args.device)

    train_dir = cfg.DATASET.TRAIN[0] if cfg.DATASET.TRAIN else None
    val_dir = cfg.DATASET.VAL[0] if cfg.DATASET.VAL else None
    if args.synthetic_data:
        train_dir = os.path.join(cfg.OUTPUT_DIR, "data", "train")
        val_dir = os.path.join(cfg.OUTPUT_DIR, "data", "val")
        if is_rank0():
            _ensure_synthetic(train_dir, num_files=4, slices=2, seed=cfg.SEED)
            _ensure_synthetic(val_dir, num_files=1, slices=2,
                              seed=cfg.SEED + 10_000)
        if dist.is_initialized():
            dist.barrier()
        cfg.DATASET.TRAIN = (train_dir,)
        cfg.DATASET.VAL = (val_dir,)
    cfg.freeze()

    trainer = make_trainer(cfg, device)
    try:
        return trainer.fit(train_dir, val_dir, max_epochs=args.max_epochs,
                           resume=args.resume)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
