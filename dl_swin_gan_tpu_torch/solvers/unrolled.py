"""Unrolled solver: (data-consistency rule x denoiser x num_unrolls).

Counterpart of `solvers/unrolled.py` in the JAX package, with its four
rules, x0 the given init (the sliding-window image) or A^H y:

  dlespirit / pgd  x <- x + eta * (A^H A x - A^H y); x <- denoiser_i(x),
                   a learnable step eta (`step_size`) initialised to -2.0
  modl / hqs       z = denoiser_i(x); x <- CG on (A^H A + mu) x = A^H y + mu z
                   from the previous x, MODL.NUM_CG_STEPS steps, each one
                   SENSE-normal launch (one more for the initial residual);
                   a learnable mu (`lamda`) initialised to 0.1
  ddpm_x / dc      x <- denoiser_i(x); x <- A_F^H (A_{1-mask} x + y): the
                   acquired samples from y, the rest from the estimate
  ddpm_e / ddpm /  the denoisers alone
  none

Under FIX_STEP_SIZE the scalar (eta or mu) takes no gradient.
"""

import contextlib
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dl_swin_gan_tpu_torch.ops.cg import conjugate_gradient
from dl_swin_gan_tpu_torch.ops.sense import SenseOp

DC_MODES = ("pgd", "hqs", "dc", "none")


@contextlib.contextmanager
def _replay(generators, states):
    """Run the recompute with each generator back at the state it had before
    the checkpointed forward, then return it to where it is now."""
    now = [g.get_state() for g in generators]
    for g, state in zip(generators, states):
        g.set_state(state)
    try:
        yield
    finally:
        for g, state in zip(generators, now):
            g.set_state(state)


def _checkpoint_replaying_dropout(net: nn.Module, x: torch.Tensor, *args):
    """`checkpoint(net, x, *args)` whose recompute draws the same dropout
    (DropPath masks, LabelEmbedder drops: every training-mode module with a
    `generator`) as the forward did. torch's checkpoint restores only the
    default CPU and CUDA RNG states, not the explicit generators these
    modules draw from, so without the replay the
    backward would run on other draws than the forward (JAX's remat
    replays its dropout key the same way)."""
    generators = list({id(m.generator): m.generator for m in net.modules()
                       if m.training
                       and getattr(m, "generator", None) is not None
                       }.values())
    states = [g.get_state() for g in generators]
    return checkpoint(net, x, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _replay(generators, states)))


class UnrolledSolver(nn.Module):
    """solver(y, maps, mask, x0=None)
      y     [N, C, T, Y, X] complex   masked k-space
      maps  [N, E, C, 1, Y, X] complex
      mask  [N, 1, T, Y, X] float
      x0    [N, E, T, Y, X] complex   optional init
    """

    def __init__(self, make_denoiser: Callable[[], nn.Module],
                 num_unrolls: int = 5, dc_mode: str = "pgd",
                 share_weights: bool = False, fix_step_size: bool = False,
                 num_cg_steps: int = 10, remat: bool = False):
        super().__init__()
        if dc_mode not in DC_MODES:
            raise ValueError(f"Unknown dc_mode: {dc_mode}")
        self.num_unrolls = num_unrolls
        self.dc_mode = dc_mode
        self.share_weights = share_weights
        self.fix_step_size = fix_step_size
        self.num_cg_steps = num_cg_steps
        self.remat = remat
        # the ranks that hold the other slices of a data-parallel batch: the
        # hqs CG's inner products sum over them (set by the trainer)
        self.batch_group = None
        n_nets = 1 if share_weights else num_unrolls
        self.nets = nn.ModuleList(make_denoiser() for _ in range(n_nets))
        # the rule's scalar, as the JAX solver creates it: only pgd and hqs
        # have one
        if dc_mode == "pgd":
            self.step_size = nn.Parameter(torch.full((1,), -2.0))
        elif dc_mode == "hqs":
            self.lamda = nn.Parameter(torch.full((1,), 0.1))

    def _scalar(self, p: torch.Tensor) -> torch.Tensor:
        return (p.detach() if self.fix_step_size else p)[0]

    def _denoise(self, i: int, x: torch.Tensor) -> torch.Tensor:
        net = self.nets[0 if self.share_weights else i]
        if self.remat and torch.is_grad_enabled():
            return _checkpoint_replaying_dropout(net, x)
        return net(x)

    def forward(self, y, maps, mask, x0: Optional[torch.Tensor] = None):
        A = SenseOp(maps, mask)
        ATy = A(y, adjoint=True)
        x = ATy if x0 is None else x0
        if self.dc_mode == "pgd":
            eta = self._scalar(self.step_size)
            for i in range(self.num_unrolls):
                x = x + eta * (A.normal(x) - ATy)
                x = self._denoise(i, x)
        elif self.dc_mode == "hqs":
            mu = self._scalar(self.lamda)

            def normal(m):
                return A.normal(m) + mu * m

            for i in range(self.num_unrolls):
                z = self._denoise(i, x)
                x = conjugate_gradient(normal, x, ATy + mu * z,
                                       self.num_cg_steps, self.batch_group)
        elif self.dc_mode == "dc":
            unacquired = SenseOp(maps, 1.0 - mask)
            full = SenseOp(maps, None)
            for i in range(self.num_unrolls):
                x = self._denoise(i, x)
                x = full(unacquired(x) + y, adjoint=True)
        else:
            for i in range(self.num_unrolls):
                x = self._denoise(i, x)
        return x


_DC_MODE_FROM_META = {
    "dlespirit": "pgd",
    "pgd": "pgd",
    "modl": "hqs",
    "hqs": "hqs",
    "ddpm_x": "dc",
    "dc": "dc",
    "ddpm_e": "none",
    "ddpm": "none",
    "none": "none",
}


def build_solver(cfg, generator: Optional[torch.Generator] = None,
                 dc_mode: Optional[str] = None) -> UnrolledSolver:
    """Construct the solver and its denoisers from a config; `generator`
    seeds the weights (torch-default init) and nothing else: the DropPath
    draws come from the trainer's own generator."""
    from dl_swin_gan_tpu_torch.models import DIFFUSION_MODELS, build_denoiser

    if cfg.MODEL.MODEL_TYPE.upper() in DIFFUSION_MODELS:
        raise ValueError(
            f"MODEL_TYPE={cfg.MODEL.MODEL_TYPE} is a diffusion backbone, "
            "conditioned on (t, c): build it with build_diffusion_solver "
            "(solvers.build_model dispatches)")
    p = cfg.MODEL.PARAMETERS
    meta = (dc_mode or cfg.MODEL.META_ARCHITECTURE).lower()
    if meta not in _DC_MODE_FROM_META:
        raise ValueError(f"Unknown META_ARCHITECTURE: {meta}")
    return UnrolledSolver(
        make_denoiser=lambda: build_denoiser(cfg, generator),
        num_unrolls=p.NUM_UNROLLS,
        dc_mode=_DC_MODE_FROM_META[meta],
        share_weights=p.SHARE_WEIGHTS,
        fix_step_size=p.FIX_STEP_SIZE,
        num_cg_steps=p.MODL.NUM_CG_STEPS,
        remat=p.GRAD_CHECKPOINT,
    )
