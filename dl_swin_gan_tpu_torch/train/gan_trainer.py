"""Adversarial trainer: an unrolled (Swin) generator and a 3D PatchGAN
discriminator under the LSGAN objective

    L_D = 1/2 E[(D(real) - 1)^2] + 1/2 E[D(fake)^2]
    L_G = recon_loss + ADV_WEIGHT * E[(D(fake) - 1)^2]

Counterpart of `train/gan_trainer.py` in the JAX package. Each step first
updates D on (target, the generator's output held fixed), then G against
the updated D. D has its own Adam at MODEL.GAN.DISC_LR, with its own
StepLR, clipping and accumulation from the same OPTIMIZER settings.

The JAX step runs the generator forward twice with the same dropout key: once
for D's update and once inside G's gradient. Here it runs once: D's input is
`pred.detach()`, the same function of the same parameters and DropPath
draws, so the step computes the same thing with one Swin forward fewer. D
takes no gradient from G's loss (its parameters stop requiring grad for G's
backward), and its gradients are zeroed with G's, before its own backward.

The state keeps the generator as `model`, so validation, serving and
`load_checkpoint_params` see the generator; a checkpoint also holds the
discriminator and both optimizers, which `--resume` restores. Under a mesh
the generator and the discriminator are two wrapped roots (FSDP2 each; the
tensor-parallel plan on the generator only), and both losses are the
global batch's.
"""

import logging
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from dl_swin_gan_tpu_torch.models.discriminator import PatchDiscriminator3D
from dl_swin_gan_tpu_torch.parallel.mesh import (
    apply_fsdp, global_mean, shard_batch,
)
from dl_swin_gan_tpu_torch.train.losses import select_loss
from dl_swin_gan_tpu_torch.train.train_state import (
    TrainState, ema_update, full_model_state, full_optimizer_state,
    is_sharded, load_full_model_state, load_full_optimizer_state,
    make_lr_schedule, make_optimizer,
)
from dl_swin_gan_tpu_torch.train.trainer import Trainer, dropout_seed

logger = logging.getLogger(__name__)


@dataclass
class GANTrainState(TrainState):
    """TrainState (the generator as `model`) with the discriminator and its
    optimizer."""
    disc: Optional[nn.Module] = None
    d_optimizer: Optional[torch.optim.Optimizer] = None

    def state_dict(self) -> dict:
        out = super().state_dict()
        if not is_sharded(self.disc):
            return {**out, "disc": self.disc.state_dict(),
                    "d_optimizer": self.d_optimizer.state_dict()}
        disc = full_model_state(self.disc)
        d_optimizer = full_optimizer_state(self.disc, self.d_optimizer)
        return None if out is None else {**out, "disc": disc,
                                         "d_optimizer": d_optimizer}

    def load_state_dict(self, payload: dict) -> None:
        super().load_state_dict(payload)
        if is_sharded(self.disc):
            load_full_model_state(self.disc, payload["disc"])
            load_full_optimizer_state(self.disc, self.d_optimizer,
                                      payload["d_optimizer"])
            return
        self.disc.load_state_dict(payload["disc"])
        self.d_optimizer.load_state_dict(payload["d_optimizer"])


class GANTrainer(Trainer):
    """Trainer with an adversarial term on top of the unrolled generator."""

    def __init__(self, cfg, **kw):
        d_cfg = cfg.clone()
        d_cfg.defrost()
        d_cfg.OPTIMIZER.ADAM.LR = cfg.MODEL.GAN.DISC_LR
        d_cfg.freeze()
        self._d_cfg = d_cfg
        super().__init__(cfg, **kw)
        self.adv_weight = cfg.MODEL.GAN.ADV_WEIGHT

    def set_steps_per_epoch(self, n: int) -> None:
        super().set_steps_per_epoch(n)
        self.d_lr_schedule = make_lr_schedule(self._d_cfg,
                                              self.steps_per_epoch)

    def init_state(self, seed: Optional[int] = None,
                   state_dict: Optional[dict] = None,
                   disc_state_dict: Optional[dict] = None) -> GANTrainState:
        """The base state (the generator from `seed` or `state_dict`) and a
        discriminator from seed + 1 or `disc_state_dict`, with their
        optimizers."""
        seed = self.cfg.SEED if seed is None else seed
        base = super().init_state(seed, state_dict)
        g = self.cfg.MODEL.GAN
        disc = PatchDiscriminator3D(g.DISC_FEATURES, g.DISC_LAYERS,
                                    torch.Generator().manual_seed(seed + 1))
        if disc_state_dict is not None:
            disc.load_state_dict(disc_state_dict)
        disc.to(self.device)
        if self.mesh is not None:
            apply_fsdp(disc, self.mesh)
        logger.info("GAN: discriminator %.3fM params",
                    sum(p.numel() for p in disc.parameters()) / 1e6)
        return GANTrainState(
            step=base.step, model=base.model, optimizer=base.optimizer,
            ema=base.ema, disc=disc,
            d_optimizer=make_optimizer(self._d_cfg, disc.parameters()))

    def train_step(self, state: GANTrainState, batch: dict
                   ) -> Dict[str, torch.Tensor]:
        model, disc = state.model.train(), state.disc.train()
        self._set_batch_group(model, True)
        b = self._to_device(shard_batch(batch, self.mesh))
        self.dropout_generator.manual_seed(
            dropout_seed(self.cfg.SEED + 17, state.step))
        if state.step % self.accum == 0:
            state.optimizer.zero_grad(set_to_none=True)
            state.d_optimizer.zero_grad(set_to_none=True)
        pred = self._apply(model, b)

        # the discriminator, on the generator's output held fixed
        d_real = disc(b["target"])
        d_fake = disc(pred.detach())
        d_loss = 0.5 * (torch.mean((d_real - 1.0) ** 2)
                        + torch.mean(d_fake ** 2))
        d_loss.backward()
        self._update(disc.parameters(), state.d_optimizer, self.d_lr_schedule,
                     state.step)

        # the generator, against the updated discriminator
        metrics = self._metrics(pred, b, "Train", sharded=True)
        recon = select_loss(metrics, self.loss_name, "Train")
        disc.requires_grad_(False)
        try:
            adv = torch.mean((disc(pred) - 1.0) ** 2)
            (recon + self.adv_weight * adv).backward()
        finally:
            disc.requires_grad_(True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(global_mean({"Train/adv_loss": adv.detach(),
                                    "Train/disc_loss": d_loss.detach()},
                                   self.mesh))
        metrics.update(self._extra_metrics(model))

        self._update(model.parameters(), state.optimizer, self.lr_schedule,
                     state.step)
        if self.use_ema:
            ema_update(state.ema, model, self.ema_decay)
        state.step += 1
        return metrics
