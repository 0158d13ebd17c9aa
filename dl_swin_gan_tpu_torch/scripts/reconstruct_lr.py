"""DSLR inference on prepared H5 data: re-undersample every slice at a
fixed acceleration (parity seed 1000), run the low-rank alternating
minimisation of a DSLR META_ARCHITECTURE, write `<name>_<R>accel.im`.

Counterpart of `scripts/reconstruct_lr.py` beside the JAX package, with
its arguments plus `--device`: `infer.reconstruct_h5_file`, which serves
the DSLR modes through LRReconstructor. It runs on the GPU unless
`--device cpu` is given. It needs pyyaml and h5py.

    python -m dl_swin_gan_tpu_torch.scripts.reconstruct_lr \\
        --config-file configs/quality/dslr.yaml --ckpt runs/x/checkpoints \\
        --file data.h5 --out-directory out/ --acceleration 12
"""

import argparse
import logging

from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.infer import (
    load_checkpoint_params, reconstruct_h5_file,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint directory of the port's trainer")
    parser.add_argument("--file", required=True, help="input .h5 file")
    parser.add_argument("--out-directory", required=True)
    parser.add_argument("--acceleration", type=float, default=12)
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when not given")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    cfg = load_cfg(args.config_file, freeze=False)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    out = reconstruct_h5_file(args.file, args.out_directory, cfg,
                              load_checkpoint_params(args.ckpt),
                              acceleration=args.acceleration,
                              device=args.device)
    print(out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
