"""Command lines of the port: evaluation, CFL and H5 reconstruction, the
quality-row driver, and the ports of the root scripts (batch_recon, eval,
eval_recon, display_data, write_dcm). Each runs as `python -m
dl_swin_gan_tpu_torch.scripts.<name>`."""
