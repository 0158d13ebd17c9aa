"""The canonical headline operating point, in one place.

`configs/basic/example.yaml`: 5 unrolls x 2 resblocks x 64 features, PGD with
a fixed step size, sliding-window init, real (split re/im channel) convs, on
a 20x180x64 cine slice with 8 coils and 2 ESPIRiT maps. The same point as the
JAX package's `utils/headline.py`; `chip_smoke.py` runs it.
"""


def headline_cfg(output_dir: str = "runs/headline"):
    """Config at the headline operating point, built in code (no YAML)."""
    from dl_swin_gan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "RES"
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 5
    cfg.MODEL.PARAMETERS.NUM_RESBLOCKS = 2
    cfg.MODEL.PARAMETERS.NUM_FEATURES = 64
    cfg.MODEL.PARAMETERS.FIX_STEP_SIZE = True
    cfg.MODEL.PARAMETERS.SLWIN_INIT = True
    cfg.MODEL.PARAMETERS.CONV_BLOCK.COMPLEX = False
    cfg.OUTPUT_DIR = output_dir
    return cfg


def headline_shape():
    """(T, Y, X, C, E) of the headline cine slice (readout cropped to 64)."""
    return 20, 180, 64, 8, 2
