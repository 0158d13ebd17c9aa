"""H5 inference (RES, SWIN): re-undersample fully-sampled data at a fixed
acceleration (parity seed 1000) and reconstruct; acceleration 1 writes the
fully-sampled adjoint reference.

Counterpart of `scripts/reconstruct_h5.py` beside the JAX package, with its
arguments less `--data-parallel` (ROADMAP.md Queue 1 item 12) and
`--model`/`--sample-steps` (diffusion, item 10), plus `--device`. It runs
on the GPU unless `--device cpu` is given. It needs pyyaml and h5py.

    python -m dl_swin_gan_tpu_torch.scripts.reconstruct_h5 \\
        --config-file cfg.yaml --ckpt runs/x/checkpoints --file data.h5 \\
        --out-directory out/ --acceleration 12
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
    parser.add_argument("--acceleration", type=float, default=1)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--use-ema", action="store_true",
                        help="reconstruct with the EMA weights")
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when not given")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    cfg = load_cfg(args.config_file, freeze=False)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    params = (load_checkpoint_params(args.ckpt, use_ema=args.use_ema)
              if args.acceleration > 1 else None)
    out = reconstruct_h5_file(args.file, args.out_directory, cfg, params,
                              acceleration=args.acceleration,
                              batch_size=args.batch_size, device=args.device)
    print(out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
