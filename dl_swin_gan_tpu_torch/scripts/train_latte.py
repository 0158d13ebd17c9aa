"""python -m dl_swin_gan_tpu_torch.scripts.train_latte --config-file <yaml>
[options] [KEY VALUE ...]: `train_dit` under the name of the JAX package's
`scripts/train_Latte.py` (MODEL.MODEL_TYPE in the config picks the
backbone), such as

    python -m dl_swin_gan_tpu_torch.scripts.train_latte \\
        --config-file configs/config_latte.yaml --synthetic-data
"""

from dl_swin_gan_tpu_torch.scripts.train_dit import main as _main


def main(argv=None):
    return _main(argv, "Train Latte diffusion recon (torch port)")


if __name__ == "__main__":
    main()
