"""H5 inference: re-undersample fully-sampled data at a fixed acceleration
(parity seed 1000) and reconstruct, with the unrolled solver or, for DiT,
Latte and SwinDiff, by conditional diffusion sampling; acceleration 1 writes
the fully-sampled adjoint reference.

Counterpart of `scripts/reconstruct_h5.py` beside the JAX package, with its
arguments plus `--device`. `--model` overrides MODEL.MODEL_TYPE and
`--sample-steps` sets the diffusion sampling steps. It runs on the GPU
unless `--device cpu` is given. `--data-parallel` serves each batch over
the ranks torchrun starts (NCCL, one GPU a rank; gloo with `--device
cpu`), and rank 0 writes. It needs pyyaml and h5py.

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
from dl_swin_gan_tpu_torch.parallel.mesh import init_torchrun, make_mesh


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint directory of the port's trainer")
    parser.add_argument("--file", required=True, help="input .h5 file")
    parser.add_argument("--out-directory", required=True)
    parser.add_argument("--acceleration", type=float, default=1)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard each batch over the torchrun ranks")
    parser.add_argument("--model", default=None,
                        help="MODEL.MODEL_TYPE override (e.g. DiT, Latte)")
    parser.add_argument("--sample-steps", type=int, default=100,
                        help="diffusion sampling steps (DiT, Latte)")
    parser.add_argument("--use-ema", action="store_true",
                        help="reconstruct with the EMA weights")
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when not given")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    cfg = load_cfg(args.config_file, freeze=False)
    if args.model:
        cfg.MODEL.MODEL_TYPE = args.model
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    device, mesh = args.device, None
    if args.data_parallel:
        device = init_torchrun(args.device)
        mesh = make_mesh()
    params = (load_checkpoint_params(args.ckpt, use_ema=args.use_ema)
              if args.acceleration > 1 else None)
    out = reconstruct_h5_file(args.file, args.out_directory, cfg, params,
                              acceleration=args.acceleration,
                              batch_size=args.batch_size, device=device,
                              sample_steps=args.sample_steps, mesh=mesh)
    print(out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
