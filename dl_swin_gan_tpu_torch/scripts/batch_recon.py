"""Reconstruct every .h5 of a directory into a subfolder named after the
experiment's hyperparameters (`utils/folder_param.parameter_to_folder`).

Counterpart of the root `scripts/batch_recon.py` (the reference's
`batch_recon.py:10-42`), with its arguments plus `--device`: each file goes
through the port's `reconstruct_h5_file`, which writes
`<out>/<folder>/<name>_<R>accel.im`. Acceleration 1 writes the
fully-sampled adjoint and needs no checkpoint. It runs on the GPU unless
`--device cpu` is given, and needs pyyaml and h5py.

    python -m dl_swin_gan_tpu_torch.scripts.batch_recon \\
        --config-file cfg.yaml --ckpt runs/x/checkpoints \\
        --data-directory data/test --out-directory runs/x/recon \\
        --acceleration 12
"""

import argparse
import glob
import logging
import os

from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.infer import (
    load_checkpoint_params, reconstruct_h5_file,
)
from dl_swin_gan_tpu_torch.utils.folder_param import parameter_to_folder

logger = logging.getLogger(__name__)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint directory of the port's trainer")
    parser.add_argument("--data-directory", required=True)
    parser.add_argument("--out-directory", required=True)
    parser.add_argument("--acceleration", type=float, default=1)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when not given")
    args = parser.parse_args(argv)

    cfg = load_cfg(args.config_file)
    out_dir = os.path.join(args.out_directory, parameter_to_folder(cfg))
    params = (load_checkpoint_params(args.ckpt)
              if args.acceleration > 1 else None)
    files = sorted(glob.glob(os.path.join(args.data_directory, "*.h5")))
    logger.info("reconstructing %d files -> %s", len(files), out_dir)
    return [reconstruct_h5_file(f, out_dir, cfg, params,
                                acceleration=args.acceleration,
                                batch_size=args.batch_size,
                                device=args.device)
            for f in files]


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
