"""Default config tree, key-compatible with `config/defaults.py` in the JAX
package so the same YAML files load in both. Only `MODEL.DEVICE` differs in
value ("cuda"). The PARALLEL node and DATALOADER.PREFETCH /
DEVICE_PIPELINE are kept for key compatibility; this package's
reconstruction path does not read them.
"""

from dl_swin_gan_tpu_torch.config.config import CfgNode as CN


def make_defaults() -> CN:
    _C = CN()
    _C.VERSION = 1

    _C.MODEL = CN()
    _C.MODEL.DEVICE = "cuda"
    _C.MODEL.NAME = "DLESPIRiT3D"
    _C.MODEL.MODEL_TYPE = "RES"            # RES | SE | CBAM | SWIN | DIT | LATTE
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.META_ARCHITECTURE = "dlespirit"  # dlespirit | modl | DDPM_X | DDPM_E
    _C.MODEL.STRATEGY = "standard"

    # ----- unrolled model parameters
    _C.MODEL.PARAMETERS = CN()
    _C.MODEL.PARAMETERS.NUM_UNROLLS = 5
    _C.MODEL.PARAMETERS.NUM_RESBLOCKS = 2
    _C.MODEL.PARAMETERS.NUM_SWINBLOCKS = 2
    _C.MODEL.PARAMETERS.NUM_LAYERS = 12    # swin / dit depth
    _C.MODEL.PARAMETERS.NUM_HEADS = 6
    _C.MODEL.PARAMETERS.RR = 16            # SE reduction ratio
    _C.MODEL.PARAMETERS.NUM_FEATURES = 256
    _C.MODEL.PARAMETERS.DROPOUT = 0.0
    _C.MODEL.PARAMETERS.NUM_EMAPS = 2
    _C.MODEL.PARAMETERS.NUM_COILS = 8

    # diffusion flags
    _C.MODEL.PARAMETERS.NOISE_SCHED = "linear"
    _C.MODEL.PARAMETERS.LEARN_SIGMA = False

    # unrolled flags
    _C.MODEL.PARAMETERS.FIX_STEP_SIZE = False
    _C.MODEL.PARAMETERS.SHARE_WEIGHTS = False
    _C.MODEL.PARAMETERS.SLWIN_INIT = False
    _C.MODEL.PARAMETERS.GRAD_CHECKPOINT = False

    # MoDL flags
    _C.MODEL.PARAMETERS.MODL = CN()
    _C.MODEL.PARAMETERS.MODL.NUM_CG_STEPS = 10
    _C.MODEL.PARAMETERS.MODL.MU = 0.1
    _C.MODEL.PARAMETERS.MODL.FIX_PENALTY = False

    # DSLR flags
    _C.MODEL.PARAMETERS.DSLR = CN()
    _C.MODEL.PARAMETERS.DSLR.NUM_BASIS = 8
    _C.MODEL.PARAMETERS.DSLR.BLOCK_SIZE = 16
    _C.MODEL.PARAMETERS.DSLR.OVERLAPPING = True
    _C.MODEL.PARAMETERS.DSLR.NUM_CG_STEPS = 10

    # swin parameters
    _C.MODEL.PARAMETERS.WINDOW_SIZE = (4, 4)
    _C.MODEL.PARAMETERS.NUM_HEAD = 4
    _C.MODEL.PARAMETERS.PRETRAINED = ""
    _C.MODEL.PARAMETERS.PRETRAINED_STAGE = -1
    _C.MODEL.PARAMETERS.PATCH_SIZE = (2, 4, 4)   # DiT/Latte patchify

    # conv-block parameters
    _C.MODEL.PARAMETERS.CONV_BLOCK = CN()
    _C.MODEL.PARAMETERS.CONV_BLOCK.KERNEL_SIZE = (3,)
    _C.MODEL.PARAMETERS.CONV_BLOCK.CIRCULAR_PAD = True
    _C.MODEL.PARAMETERS.CONV_BLOCK.ACTIVATION = "relu"
    _C.MODEL.PARAMETERS.CONV_BLOCK.NORM = "none"
    _C.MODEL.PARAMETERS.CONV_BLOCK.SEPARABLE = False
    _C.MODEL.PARAMETERS.CONV_BLOCK.COMPLEX = True
    # conv compute type: float32 | bfloat16
    _C.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "float32"

    # ----- adversarial extension
    _C.MODEL.GAN = CN()
    _C.MODEL.GAN.ADV_WEIGHT = 0.01
    _C.MODEL.GAN.DISC_FEATURES = 64
    _C.MODEL.GAN.DISC_LAYERS = 3
    _C.MODEL.GAN.DISC_LR = 0.0002

    # loss
    _C.MODEL.RECON_LOSS = CN()
    _C.MODEL.RECON_LOSS.NAME = "complex_l1"
    _C.MODEL.RECON_LOSS.RENORMALIZE_DATA = True
    _C.MODEL.RECON_LOSS.LOSS_WEIGHT = False

    # ----- datasets / loader
    _C.DATASET = CN()
    _C.DATASET.TRAIN = ()
    _C.DATASET.VAL = ()
    _C.DATASET.TEST = ()

    _C.DATALOADER = CN()
    _C.DATALOADER.TRAIN_BATCH_SIZE = 1
    _C.DATALOADER.VAL_BATCH_SIZE = 1
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.SUBSAMPLE = 1.0
    _C.DATALOADER.PREFETCH = 2
    _C.DATALOADER.DEVICE_PIPELINE = False

    # ----- augmentation / undersampling
    def aug_node():
        a = CN()
        a.CROP_READOUT = 0
        a.ZPAD_PE = 0
        a.UNDERSAMPLE = CN()
        a.UNDERSAMPLE.NAME = "VDktMaskFunc"
        a.UNDERSAMPLE.ACCELERATIONS = (10, 15)
        a.UNDERSAMPLE.CALIBRATION_SIZE = 1
        a.UNDERSAMPLE.VD_POWER = 1.5
        a.UNDERSAMPLE.PERTURB_FACTOR = 0.4
        a.UNDERSAMPLE.ADHERE_FACTOR = 0.33
        a.UNDERSAMPLE.PARTIAL_KX = 0.25
        a.UNDERSAMPLE.PARTIAL_KY = 0.0
        return a

    _C.AUG_TRAIN = aug_node()
    _C.AUG_VAL = aug_node()

    # ----- optimizer / scheduler
    _C.OPTIMIZER = CN()
    _C.OPTIMIZER.NAME = "Adam"
    _C.OPTIMIZER.MAX_EPOCHS = 1000
    _C.OPTIMIZER.GRAD_ACCUM_ITERS = 1
    _C.OPTIMIZER.GRAD_CLIP_VAL = 0.0
    _C.OPTIMIZER.ADAM = CN()
    _C.OPTIMIZER.ADAM.LR = 0.0001
    _C.OPTIMIZER.ADAM.BETAS = (0.9, 0.999)
    _C.OPTIMIZER.ADAM.EPS = 1e-8
    _C.OPTIMIZER.ADAM.WEIGHT_DECAY = 0.0

    _C.LR_SCHEDULER = CN()
    _C.LR_SCHEDULER.NAME = "StepLR"
    _C.LR_SCHEDULER.STEP_SIZE = 1000
    _C.LR_SCHEDULER.GAMMA = 0.5

    # ----- eval / logging
    _C.EVAL = CN()
    _C.EVAL.RUN_EVERY_N_EPOCHS = 1
    _C.EVAL.CKPT_EVERY_N_STEPS = 0
    _C.EVAL.RECON_SSIM_EVERY_N_EPOCHS = 0
    _C.EVAL.MONITOR = ""

    _C.LOGGER = CN()
    _C.LOGGER.LOG_METRICS_EVERY_N_STEPS = 50
    _C.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 100
    _C.LOGGER.LOG_PREDICTION_EVERY_N_STEPS = 500

    # ----- parallelism (mesh extents of the JAX package; not read here)
    _C.PARALLEL = CN()
    _C.PARALLEL.DATA_AXIS = 1
    _C.PARALLEL.FSDP_AXIS = 1
    _C.PARALLEL.MODEL_AXIS = 1
    _C.PARALLEL.REMAT = False

    # ----- misc
    _C.OUTPUT_DIR = ""
    _C.DEVICE = -1
    _C.SEED = 1
    _C.CUDNN_BENCHMARK = False

    _C.DESCRIPTION = CN()
    _C.DESCRIPTION.BRIEF = ""
    _C.DESCRIPTION.EXP_NAME = ""
    _C.DESCRIPTION.TAGS = ()

    return _C
