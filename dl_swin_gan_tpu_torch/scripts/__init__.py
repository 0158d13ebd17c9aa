"""Command lines of the port: evaluation, CFL and H5 reconstruction, and
the quality-row driver. Each runs as `python -m
dl_swin_gan_tpu_torch.scripts.<name>`."""
