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
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from dl_swin_gan_tpu_torch.parallel.mesh import (
    full_tensor, is_rank0, permute_qkv, unpermute_qkv,
)


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
        """The single-device format on every mesh: a sharded state is
        gathered whole (a collective: every rank calls it) and only rank 0
        gets it; the others get None."""
        if not is_sharded(self.model):
            return {"step": self.step, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "ema": self.ema}
        model = full_model_state(self.model)
        optimizer = full_optimizer_state(self.model, self.optimizer)
        ema = full_ema(self.model, self.ema)
        if not is_rank0():
            return None
        return {"step": self.step, "model": model, "optimizer": optimizer,
                "ema": ema}

    def load_state_dict(self, payload: dict) -> None:
        self.step = int(payload["step"])
        if is_sharded(self.model):
            load_full_model_state(self.model, payload["model"])
            load_full_optimizer_state(self.model, self.optimizer,
                                      payload["optimizer"])
            self.ema = sharded_ema(self.model, payload["ema"])
            return
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        device = next(self.model.parameters()).device
        self.ema = {k: v.to(device) for k, v in payload["ema"].items()}


# -- a sharded state in the single-device format --------------------------
# A model wrapped by `parallel/mesh.py` (FSDP2, DTensor tensor parallelism)
# holds DTensor parameters. Its checkpoint is gathered whole onto rank 0
# (CPU offload), with the tensor-parallel qkv rows back in the unsplit
# order, and keyed as the unwrapped model's and optimizer's state dicts
# are, so serving and `convert.torch_to_flax` read it unchanged, and it
# restores on any mesh.

def is_sharded(model: nn.Module) -> bool:
    """A model `parallel/mesh.py apply_fsdp` wrapped."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def _options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, **kw)


def full_model_state(model: nn.Module) -> dict:
    from torch.distributed.checkpoint.state_dict import get_model_state_dict

    model.reshard()     # an eval forward leaves the root's weights whole
    state = get_model_state_dict(model, options=_options(cpu_offload=True))
    return unpermute_qkv(model, state) if state else state


def load_full_model_state(model: nn.Module, state: dict) -> None:
    from torch.distributed.checkpoint.state_dict import set_model_state_dict

    set_model_state_dict(model, permute_qkv(model, state),
                         options=_options())


def _per_param(model, by_name, reorder):
    """Apply a qkv reorder to every tensor-valued entry of an optimizer's
    per-parameter state, keyed by parameter name."""
    keys = {k for st in by_name.values() for k, v in st.items()
            if isinstance(v, torch.Tensor) and v.ndim > 0}
    out = {n: dict(st) for n, st in by_name.items()}
    for key in keys:
        moved = reorder(model, {n: st[key] for n, st in by_name.items()
                                if key in st})
        for n, v in moved.items():
            out[n][key] = v
    return out


def full_optimizer_state(model: nn.Module, optimizer) -> Optional[dict]:
    """The optimizer's state gathered whole, keyed by parameter index as
    `optimizer.state_dict()` keys it (rank 0; None elsewhere)."""
    from torch.distributed.checkpoint.state_dict import (
        get_optimizer_state_dict,
    )

    full = get_optimizer_state_dict(model, optimizer,
                                    options=_options(cpu_offload=True))
    if not full:
        return None
    names = [n for n, _ in model.named_parameters()]
    index = {n: i for i, n in enumerate(names)}
    state = _per_param(model, full["state"], unpermute_qkv)
    return {"state": {index[n]: st for n, st in state.items()},
            "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                             for g in full["param_groups"]]}


def load_full_optimizer_state(model: nn.Module, optimizer,
                              payload: dict) -> None:
    from torch.distributed.checkpoint.state_dict import (
        set_optimizer_state_dict,
    )

    names = [n for n, _ in model.named_parameters()]
    state = {names[int(i)]: st for i, st in payload["state"].items()}
    full = {"state": _per_param(model, state, permute_qkv),
            "param_groups": [{**g, "params": [names[int(i)]
                                              for i in g["params"]]}
                             for g in payload["param_groups"]]}
    # a parameter that took no gradient yet (a fixed step size) has no
    # Adam state, as in the unwrapped optimizer's state dict
    set_optimizer_state_dict(model, optimizer, full,
                             options=_options(strict=False))


def full_ema(model: nn.Module, ema: Dict[str, torch.Tensor]) -> dict:
    """The EMA gathered whole on the CPU, in the unsplit qkv order."""
    full = {k: full_tensor(v).cpu() for k, v in ema.items()}
    return unpermute_qkv(model, full)


def sharded_ema(model: nn.Module, ema: Dict[str, torch.Tensor]) -> dict:
    """A whole EMA laid out as the model's (sharded) parameters."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    ema = permute_qkv(model, ema)
    out = {}
    for name, p in model.named_parameters():
        if name not in ema:
            continue
        v = ema[name].to(p.device if not isinstance(p, DTensor)
                         else p.to_local().device)
        out[name] = (distribute_tensor(v, p.device_mesh, p.placements)
                     if isinstance(p, DTensor) else v)
    return out


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
    left as it is otherwise. Returns the norm (no host sync). Sharded
    (DTensor) gradients count once each, their squares summed over the
    shards; each shard is then scaled where it lies."""
    from torch.distributed.tensor import DTensor

    grads = list(grads)
    squares = [torch.sum(g * g) for g in grads]
    total = None
    for sq in squares:
        sq = full_tensor(sq) if isinstance(sq, DTensor) else sq
        total = sq if total is None else total + sq
    norm = torch.sqrt(total)
    for g in grads:
        local = g.to_local() if isinstance(g, DTensor) else g
        local.copy_(torch.where(norm < max_norm, local,
                                local / norm * max_norm))
    return norm


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module,
               decay: float = 0.9999) -> None:
    """Polyak averaging after each train step, in place."""
    for name, p in model.named_parameters():
        ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
