"""Train state, optimizer, learning-rate schedule, clipping and EMA.

Counterpart of `train/train_state.py` in the JAX package (the reference's
`configure_optimizers`, train.py:146-151: Adam + StepLR). optax's chain
`MultiSteps(clip_by_global_norm -> adam(schedule))` becomes, per optimizer
update: the gradients averaged over GRAD_ACCUM_ITERS batches, clipped by
`clip_by_global_norm_`, the learning rate set from `make_lr_schedule`, and
one `torch.optim.Adam` (AdamW with weight decay) step. The schedule is a
pure function of the update count, so the train state needs no scheduler
object: the step counter restores it.

Where torch and optax agree: Adam's update lr * m_hat / (sqrt(v_hat) + eps)
and AdamW's decoupled decay are the same in both. Where they differ, the
optax rule is written out: `torch.nn.utils.clip_grad_norm_` divides by
norm + 1e-6, optax scales by max / norm only when norm >= max.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable

import torch
from torch import nn


@dataclass
class TrainState:
    """step counts train steps (batches), as the JAX state's does; the
    optimizer updates once every GRAD_ACCUM_ITERS of them. `ema` maps each
    parameter name to its Polyak average, and is empty when EMA is off.
    The state is updated in place by `Trainer.train_step`."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor] = field(default_factory=dict)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    def load_state_dict(self, payload: dict) -> None:
        self.step = int(payload["step"])
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        device = next(self.model.parameters()).device
        self.ema = {k: v.to(device) for k, v in payload["ema"].items()}


def make_lr_schedule(cfg, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """StepLR twin: lr(update) = LR * GAMMA ** (update // boundary).

    The reference's StepLR steps once per EPOCH, so in optimizer updates the
    boundary is STEP_SIZE * updates_per_epoch. `steps_per_epoch` counts
    loader batches; with gradient accumulation an update happens every
    GRAD_ACCUM_ITERS batches, hence the division (optax's staircase
    exponential_decay under MultiSteps)."""
    accum = max(1, cfg.OPTIMIZER.GRAD_ACCUM_ITERS)
    updates_per_epoch = max(1, steps_per_epoch // accum)
    lr = cfg.OPTIMIZER.ADAM.LR
    gamma = cfg.LR_SCHEDULER.GAMMA
    boundary = max(1, cfg.LR_SCHEDULER.STEP_SIZE * updates_per_epoch)

    def schedule(update: int) -> float:
        return lr * gamma ** (update // boundary)

    return schedule


def make_optimizer(cfg, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """Adam, or AdamW when WEIGHT_DECAY > 0, at the schedule's first lr."""
    adam = cfg.OPTIMIZER.ADAM
    kwargs = dict(lr=adam.LR, betas=tuple(adam.BETAS), eps=adam.EPS)
    if adam.WEIGHT_DECAY > 0:
        return torch.optim.AdamW(params, weight_decay=adam.WEIGHT_DECAY,
                                 **kwargs)
    return torch.optim.Adam(params, **kwargs)


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient becomes
    g / norm * max_norm when the global norm is at least max_norm, and is
    left as it is otherwise. Returns the norm (no host sync)."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module,
               decay: float = 0.9999) -> None:
    """Polyak averaging after each train step, in place."""
    for name, p in model.named_parameters():
        ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
