"""The canonical operating points, in one place.

`configs/basic/example.yaml`: 5 unrolls x 2 resblocks x 64 features, PGD with
a fixed step size, sliding-window init, real (split re/im channel) convs, on
a 20x180x64 cine slice with 8 coils and 2 ESPIRiT maps. The same point as the
JAX package's `utils/headline.py`; `chip_smoke.py` runs it.

`configs/config_swin.yaml`: the unrolled-Swin model (5 unrolls x 1
swinblock x 160 features; the denoiser fixes depths (6,), 8 heads, window
(7, 8, 8)) on the same slice, with its training settings (complex L1, Adam
at 1e-4, per-epoch StepLR, batch 1); `chip_smoke.py` serves and trains it.

`configs/config_dslr.yaml`: DSLR low-rank alternating minimisation
(dslr-cg-v1, 5 unrolls, 10 CG steps per factor solve, 8 basis vectors per
16x16 block, 2D and 1D complex ResNets of 2 resblocks x 64 features) on the
same slice; `chip_smoke.py` trains and validates it.

`configs/config_se.yaml`: the squeeze-excitation trunk (5 unrolls x 1
resblock x 384 features, SE hidden width RR 16) on the same slice, readout
cropped to 48 for training; `chip_smoke.py` serves and trains it.

`configs/config_swingan.yaml`: config_swin.yaml's generator with a 3D
PatchGAN discriminator (64 features, 3 strided layers, its own Adam at 2e-4)
and an adversarial weight of 0.01; `chip_smoke.py` trains it through
GANTrainer.

`dslr_pgd_cfg`: config_dslr.yaml with META_ARCHITECTURE dslr-pgd (no
YAML); `chip_smoke.py` serves and trains it.

`configs/quality/resnet.yaml` and `resnet_bf16.yaml`: the example config's
network (f32, or with a bfloat16 conv trunk) trained on the synthetic quality
set (18x156x96 slices, `data/synthetic.quality_split`) for 40 epochs and
scored at 12x; `configs/quality/se.yaml` and `cbam.yaml` the gated trunks
(1 resblock x 96 features), `swin.yaml` the unrolled Swin (3 unrolls x 1
swinblock x 96 features) and `swingan.yaml` the same generator with a
32-feature PatchGAN discriminator, `dslr.yaml` and `dslr_fast.yaml`
config_dslr.yaml's DSLR network, on the same set; `scripts/quality_row.py`
trains and scores them.
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


def swin_cfg(output_dir: str = "runs/swin"):
    """`configs/config_swin.yaml` built in code (no YAML): every field it
    sets, which covers what the reconstruction and training paths read."""
    from dl_swin_gan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "SWIN"
    cfg.MODEL.META_ARCHITECTURE = "dlespirit"
    cfg.MODEL.STRATEGY = "standard"
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = 5
    p.NUM_RESBLOCKS = 2
    p.NUM_SWINBLOCKS = 1
    p.NUM_FEATURES = 160
    p.NUM_EMAPS = 2
    p.SHARE_WEIGHTS = False
    p.FIX_STEP_SIZE = True
    p.SLWIN_INIT = True
    p.GRAD_CHECKPOINT = True
    p.CONV_BLOCK.ACTIVATION = "relu"
    p.CONV_BLOCK.NORM = "none"
    p.CONV_BLOCK.CIRCULAR_PAD = True
    p.CONV_BLOCK.COMPLEX = False
    cfg.MODEL.RECON_LOSS.NAME = "complex_l1"
    cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    cfg.MODEL.RECON_LOSS.LOSS_WEIGHT = False
    cfg.DATALOADER.TRAIN_BATCH_SIZE = 1
    cfg.DATALOADER.VAL_BATCH_SIZE = 1
    cfg.AUG_TRAIN.CROP_READOUT = 64
    cfg.AUG_TRAIN.UNDERSAMPLE.NAME = "VDktMaskFunc"
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (10, 15)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KX = 0.25
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.25
    cfg.OPTIMIZER.NAME = "Adam"
    cfg.OPTIMIZER.MAX_EPOCHS = 999
    cfg.OPTIMIZER.GRAD_ACCUM_ITERS = 1
    cfg.OPTIMIZER.ADAM.LR = 0.0001
    cfg.EVAL.RUN_EVERY_N_EPOCHS = 1
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 50
    cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 50
    cfg.SEED = 1000
    cfg.OUTPUT_DIR = output_dir
    return cfg


def se_cfg(output_dir: str = "runs/se"):
    """`configs/config_se.yaml` built in code (no YAML): every field it
    sets."""
    from dl_swin_gan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "SE"
    cfg.MODEL.META_ARCHITECTURE = "dlespirit"
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = 5
    p.NUM_RESBLOCKS = 1
    p.NUM_FEATURES = 384
    p.NUM_EMAPS = 2
    p.RR = 16
    p.SHARE_WEIGHTS = False
    p.FIX_STEP_SIZE = True
    p.SLWIN_INIT = True
    p.GRAD_CHECKPOINT = False
    p.CONV_BLOCK.ACTIVATION = "relu"
    p.CONV_BLOCK.NORM = "none"
    p.CONV_BLOCK.CIRCULAR_PAD = True
    p.CONV_BLOCK.COMPLEX = False
    cfg.MODEL.RECON_LOSS.NAME = "complex_l1"
    cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    cfg.MODEL.RECON_LOSS.LOSS_WEIGHT = False
    cfg.DATALOADER.TRAIN_BATCH_SIZE = 1
    cfg.DATALOADER.VAL_BATCH_SIZE = 1
    cfg.AUG_TRAIN.CROP_READOUT = 48
    cfg.AUG_TRAIN.UNDERSAMPLE.NAME = "VDktMaskFunc"
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (10, 15)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KX = 0.25
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.25
    cfg.OPTIMIZER.NAME = "Adam"
    cfg.OPTIMIZER.MAX_EPOCHS = 1000
    cfg.OPTIMIZER.GRAD_ACCUM_ITERS = 1
    cfg.OPTIMIZER.ADAM.LR = 0.0001
    cfg.EVAL.RUN_EVERY_N_EPOCHS = 1
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 50
    cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 50
    cfg.SEED = 1000
    cfg.OUTPUT_DIR = output_dir
    cfg.VERSION = 1
    return cfg


def swingan_cfg(output_dir: str = "runs/swingan"):
    """`configs/config_swingan.yaml` built in code (no YAML): config_swin's
    fields with the GAN's, and every other field it sets."""
    cfg = swin_cfg(output_dir)
    g = cfg.MODEL.GAN
    g.ADV_WEIGHT = 0.01
    g.DISC_FEATURES = 64
    g.DISC_LAYERS = 3
    g.DISC_LR = 0.0002
    cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 100
    cfg.VERSION = 1
    return cfg


def dslr_cfg(output_dir: str = "runs/dslr"):
    """`configs/config_dslr.yaml` built in code (no YAML): every field it
    sets."""
    from dl_swin_gan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "RES"
    cfg.MODEL.META_ARCHITECTURE = "dslr-cg-v1"
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = 5
    p.NUM_RESBLOCKS = 2
    p.NUM_FEATURES = 64
    p.NUM_EMAPS = 2
    p.SHARE_WEIGHTS = False
    p.FIX_STEP_SIZE = False
    p.SLWIN_INIT = True
    p.GRAD_CHECKPOINT = False
    p.DSLR.NUM_BASIS = 8
    p.DSLR.BLOCK_SIZE = 16
    p.DSLR.OVERLAPPING = True
    p.DSLR.NUM_CG_STEPS = 10
    p.CONV_BLOCK.ACTIVATION = "relu"
    p.CONV_BLOCK.NORM = "none"
    p.CONV_BLOCK.CIRCULAR_PAD = True
    p.CONV_BLOCK.COMPLEX = True
    cfg.MODEL.RECON_LOSS.NAME = "complex_l1"
    cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    cfg.DATALOADER.TRAIN_BATCH_SIZE = 1
    cfg.DATALOADER.VAL_BATCH_SIZE = 1
    cfg.AUG_TRAIN.CROP_READOUT = 64
    cfg.AUG_TRAIN.UNDERSAMPLE.NAME = "VDktMaskFunc"
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (10, 15)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KX = 0.25
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.OPTIMIZER.MAX_EPOCHS = 1000
    cfg.OPTIMIZER.ADAM.LR = 0.0001
    cfg.EVAL.RUN_EVERY_N_EPOCHS = 1
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 50
    cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 100
    cfg.SEED = 1000
    cfg.VERSION = 1
    cfg.OUTPUT_DIR = output_dir
    return cfg


def dslr_pgd_cfg(output_dir: str = "runs/dslr_pgd"):
    """config_dslr.yaml's network and data with META_ARCHITECTURE dslr-pgd
    (no YAML has it: the pgd rule's one operator application per unroll in
    place of two 10-step CG solves)."""
    cfg = dslr_cfg(output_dir)
    cfg.MODEL.META_ARCHITECTURE = "dslr-pgd"
    return cfg


# quality_cfg's model -> (MODEL_TYPE, NUM_UNROLLS, NUM_RESBLOCKS,
# NUM_FEATURES, MAX_EPOCHS, EVAL.RUN_EVERY_N_EPOCHS, OUTPUT_DIR) of its YAML
_QUALITY_MODELS = {"res": ("RES", 5, 2, 64, 40, 10, "runs/resq2"),
                   "se": ("SE", 5, 1, 96, 24, 8, "runs/seq2"),
                   "cbam": ("CBAM", 5, 1, 96, 24, 8, "runs/cbamq2"),
                   "swin": ("SWIN", 3, 2, 96, 20, 10, "runs/swinq2"),
                   "swingan": ("SWIN", 3, 2, 96, 40, 10, "runs/sganq3"),
                   "latte2": ("Latte", 2, 0, 192, 1000, 20, "runs/latteq4"),
                   "dit": ("DiT", 2, 0, 256, 2000, 20, "runs/ditq2"),
                   "dit_ema": ("DiT", 2, 0, 192, 1600, 50, "runs/ditema")}

# the DSLR rows' model -> (META_ARCHITECTURE, DSLR.NUM_CG_STEPS, OUTPUT_DIR)
# of `configs/quality/dslr.yaml` and `dslr_fast.yaml`
_DSLR_QUALITY_MODELS = {"dslr": ("dslr-cg-v1", 10, "runs/dslrq2"),
                        "dslr_fast": ("dslr-cg-jacobi", 6, "runs/dslrfast")}

# the OUTPUT_DIR of the models whose bfloat16 row has a YAML of its own
# (`resnet_bf16.yaml`, `dit_bf16.yaml`)
_BF16_OUTPUT_DIRS = {"res": "runs/resbf16", "dit": "runs/ditbf16"}

# the diffusion models' further columns: (NUM_LAYERS, NUM_HEADS,
# SHARE_WEIGHTS, EVAL.CKPT_EVERY_N_STEPS, EVAL.RECON_SSIM_EVERY_N_EPOCHS)
# of their YAMLs
_DIFFUSION_QUALITY_MODELS = {"latte2": (12, 6, True, 64, 0),
                             "dit": (6, 8, False, 0, 0),
                             "dit_ema": (4, 6, False, 64, 100)}


def quality_cfg(dtype: str = "float32", model: str = "res"):
    """A quality row's config built in code (no YAML): every field its YAML
    sets. `model` "res" is `configs/quality/resnet.yaml` (float32) or
    `resnet_bf16.yaml` (bfloat16); "se", "cbam", "swin" and "swingan" are
    `configs/quality/se.yaml`, `cbam.yaml`, `swin.yaml` and `swingan.yaml`
    (float32 in their YAMLs; bfloat16 sets CONV_BLOCK.DTYPE, as the bf16
    Swin row's command line does); "latte2", "dit" and "dit_ema" the
    diffusion rows' `latte2.yaml`, `dit.yaml` and `dit_ema.yaml` (DDPM_X),
    and "dit" in bfloat16
    `dit_bf16.yaml`; "dslr" and "dslr_fast" the DSLR rows' `dslr.yaml`
    (dslr-cg-v1) and `dslr_fast.yaml` (dslr-cg-jacobi, 6 CG steps),
    float32 only. Like every quality YAML it sets
    DATALOADER.DEVICE_PIPELINE: training batches are built on the device."""
    from dl_swin_gan_tpu_torch.config import get_cfg

    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"quality_cfg: dtype {dtype!r}")
    if model in _DSLR_QUALITY_MODELS:
        if dtype != "float32":
            raise ValueError(f"quality_cfg: {model} has no {dtype} row")
        return _dslr_quality_cfg(model)
    if model not in _QUALITY_MODELS:
        raise ValueError(f"quality_cfg: model {model!r}")
    (model_type, unrolls, nres, features, epochs, every,
     output_dir) = _QUALITY_MODELS[model]
    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = model_type
    cfg.MODEL.META_ARCHITECTURE = "dlespirit"
    if model == "swingan":
        g = cfg.MODEL.GAN
        g.ADV_WEIGHT = 0.01
        g.DISC_FEATURES = 32
        g.DISC_LAYERS = 3
        g.DISC_LR = 0.0002
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = unrolls
    p.NUM_RESBLOCKS = nres
    if model_type == "SWIN":
        p.NUM_SWINBLOCKS = 1
    p.NUM_FEATURES = features
    if model_type in ("SE", "CBAM"):
        p.RR = 16
    p.NUM_EMAPS = 2
    p.SHARE_WEIGHTS = False
    p.FIX_STEP_SIZE = True
    p.SLWIN_INIT = True
    p.GRAD_CHECKPOINT = False
    p.CONV_BLOCK.DTYPE = dtype
    p.CONV_BLOCK.ACTIVATION = "relu"
    p.CONV_BLOCK.NORM = "none"
    p.CONV_BLOCK.CIRCULAR_PAD = True
    p.CONV_BLOCK.COMPLEX = False
    cfg.MODEL.RECON_LOSS.NAME = "complex_l1"
    cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    cfg.DATASET.TRAIN = ("runs/quality/data/train",)
    cfg.DATASET.VAL = ("runs/quality/data/validate",)
    cfg.DATALOADER.NUM_WORKERS = 8
    cfg.DATALOADER.DEVICE_PIPELINE = True
    cfg.DATALOADER.TRAIN_BATCH_SIZE = 1
    cfg.DATALOADER.VAL_BATCH_SIZE = 1
    for aug in (cfg.AUG_TRAIN, cfg.AUG_VAL):
        aug.CROP_READOUT = 64
        aug.UNDERSAMPLE.NAME = "VDktMaskFunc"
        aug.UNDERSAMPLE.ACCELERATIONS = (10, 15)
        aug.UNDERSAMPLE.PARTIAL_KX = 0.25
        aug.UNDERSAMPLE.PARTIAL_KY = 0.25
    cfg.OPTIMIZER.NAME = "Adam"
    cfg.OPTIMIZER.MAX_EPOCHS = epochs
    cfg.OPTIMIZER.GRAD_ACCUM_ITERS = 1
    cfg.OPTIMIZER.ADAM.LR = 0.0001
    cfg.EVAL.RUN_EVERY_N_EPOCHS = every
    cfg.EVAL.CKPT_EVERY_N_STEPS = 96
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 32
    cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 0
    cfg.SEED = 1000
    cfg.OUTPUT_DIR = (_BF16_OUTPUT_DIRS.get(model, output_dir)
                      if dtype == "bfloat16" else output_dir)
    cfg.VERSION = 1
    if model in _DIFFUSION_QUALITY_MODELS:
        _diffusion_fields(cfg, model)
    return cfg


def _diffusion_fields(cfg, model: str) -> None:
    """Where `configs/quality/latte2.yaml`, `dit.yaml` and `dit_ema.yaml`
    differ from the other quality YAMLs: hard-DC (DDPM_X) unrolls, 1000
    training steps of the linear schedule, transformer widths, StepLR."""
    (layers, heads, share, ckpt_every,
     recon_ssim_every) = _DIFFUSION_QUALITY_MODELS[model]
    cfg.MODEL.META_ARCHITECTURE = "DDPM_X"
    cfg.MODEL.STRATEGY = "none"
    p = cfg.MODEL.PARAMETERS
    if model == "latte2":
        p.NUM_SWINBLOCKS = 0
    p.NUM_LAYERS = layers
    p.NUM_HEADS = heads
    p.SHARE_WEIGHTS = share
    p.SLWIN_INIT = False
    p.LEARN_SIGMA = False
    p.NOISE_SCHED = "linear"
    p.PATCH_SIZE = (2, 4, 4)
    cfg.MODEL.RECON_LOSS.LOSS_WEIGHT = False
    cfg.LR_SCHEDULER.STEP_SIZE = 1000
    cfg.LR_SCHEDULER.GAMMA = 0.5
    cfg.EVAL.CKPT_EVERY_N_STEPS = ckpt_every
    cfg.EVAL.RECON_SSIM_EVERY_N_EPOCHS = recon_ssim_every
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 50
    cfg.LOGGER.LOG_PREDICTION_EVERY_N_STEPS = 0


def _dslr_quality_cfg(model: str):
    """`configs/quality/dslr.yaml` or `dslr_fast.yaml`: config_dslr.yaml's
    network on the quality set, Adam at 2e-4, 600 epochs, validation every
    25, a checkpoint every 8 steps."""
    meta, cg_steps, output_dir = _DSLR_QUALITY_MODELS[model]
    cfg = dslr_cfg(output_dir)
    cfg.MODEL.META_ARCHITECTURE = meta
    cfg.MODEL.PARAMETERS.DSLR.NUM_CG_STEPS = cg_steps
    cfg.DATASET.TRAIN = ("runs/quality/data/train",)
    cfg.DATASET.VAL = ("runs/quality/data/validate",)
    cfg.DATALOADER.NUM_WORKERS = 8
    cfg.DATALOADER.DEVICE_PIPELINE = True
    aug = cfg.AUG_VAL
    aug.CROP_READOUT = 64
    aug.UNDERSAMPLE.NAME = "VDktMaskFunc"
    aug.UNDERSAMPLE.ACCELERATIONS = (10, 15)
    aug.UNDERSAMPLE.PARTIAL_KX = 0.25
    aug.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.OPTIMIZER.MAX_EPOCHS = 600
    cfg.OPTIMIZER.ADAM.LR = 0.0002
    cfg.EVAL.RUN_EVERY_N_EPOCHS = 25
    cfg.EVAL.CKPT_EVERY_N_STEPS = 8
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 32
    cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 0
    return cfg
