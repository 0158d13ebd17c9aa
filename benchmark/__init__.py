"""The benchmark of dl_swin_gan_tpu_torch: `python3 benchmark/run.py`."""
