"""Training: metrics and losses, train state, checkpoints, the Trainer,
DSLRTrainer, GANTrainer and DiffusionTrainer, and their command lines
(`python -m dl_swin_gan_tpu_torch.train`, `python -m
dl_swin_gan_tpu_torch.train.train_lr`, `python -m
dl_swin_gan_tpu_torch.scripts.train_swin_gan`, `python -m
dl_swin_gan_tpu_torch.scripts.train_dit` and `...scripts.train_latte`)."""

from dl_swin_gan_tpu_torch.train.checkpoint import CheckpointManager
from dl_swin_gan_tpu_torch.train.diffusion_trainer import DiffusionTrainer
from dl_swin_gan_tpu_torch.train.dslr_trainer import DSLRTrainer
from dl_swin_gan_tpu_torch.train.gan_trainer import GANTrainer, GANTrainState
from dl_swin_gan_tpu_torch.train.losses import compute_metrics, select_loss
from dl_swin_gan_tpu_torch.train.train_state import (
    TrainState, clip_by_global_norm_, ema_update, make_lr_schedule,
    make_optimizer,
)
from dl_swin_gan_tpu_torch.train.trainer import MetricsWriter, Trainer
