"""CFL inference, the deployment path: BART-dim CFL k-space and ESPIRiT
maps in, an image CFL out.

Counterpart of `scripts/reconstruct.py` beside the JAX package, with its
arguments plus `--device`. It runs on the GPU unless `--device cpu` is
given. `--data-parallel` serves each batch over the ranks torchrun starts
(NCCL, one GPU a rank; gloo with `--device cpu`), and rank 0 writes. The
YAML needs pyyaml.

    python -m dl_swin_gan_tpu_torch.scripts.reconstruct --config-file cfg.yaml \\
        --ckpt runs/x/checkpoints --kspace ks --maps mps --output im.dl
    torchrun --nproc-per-node 4 -m dl_swin_gan_tpu_torch.scripts.reconstruct \\
        --data-parallel --batch-size 4 --config-file cfg.yaml ...
"""

import argparse
import logging

from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.infer import load_checkpoint_params, reconstruct_cfl
from dl_swin_gan_tpu_torch.parallel.mesh import init_torchrun, make_mesh


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint directory of the port's trainer")
    parser.add_argument("--kspace", required=True,
                        help="input k-space CFL (no ext)")
    parser.add_argument("--maps", required=True,
                        help="ESPIRiT maps CFL (no ext)")
    parser.add_argument("--output", required=True,
                        help="output image CFL (no ext)")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard each batch over the torchrun ranks")
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when not given")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    cfg = load_cfg(args.config_file, freeze=False)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    device, mesh = args.device, None
    if args.data_parallel:
        device = init_torchrun(args.device)
        mesh = make_mesh()
    params = load_checkpoint_params(args.ckpt)
    out = reconstruct_cfl(args.kspace, args.maps, args.output, cfg, params,
                          batch_size=args.batch_size, device=device,
                          mesh=mesh)
    print(out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
