"""Unrolled meta-architectures for the diffusion denoisers (DiT, Latte,
SwinDiff).

Counterpart of `solvers/diffusion_unrolled.py` in the JAX package (the
reference's unrolledDiT / unrolledLatte, one class with the backbone
injected):

  none / ddpm   the (t, c)-conditioned denoisers alone
  dc            denoise, then hard k-space replacement
                x <- A_F^H (A_1 x + A x0), where x0 is the solver's input
                image (the noisy x_t), not raw k-space
  pgd           x <- x + eta (A^H (A x) - x0); denoise (x0 plays A^H y);
                the forward and the adjoint are called one after the
                other, as in the JAX package, never the fused normal op
  hqs           MoDL: z = denoise(x); CG on (A^H A + mu) x = x0 + mu z

With LEARN_SIGMA only the final unroll's denoiser emits twice the channels;
with shared weights that makes two nets. GRAD_CHECKPOINT recomputes each
denoiser in the backward (`torch.utils.checkpoint`), replaying its dropout
draws. None of these rules calls the SENSE-normal kernel: the diffusion
paths reach only the window-attention kernels, through SwinDiff.
"""

from typing import Callable, Optional

import torch
from torch import nn

from dl_swin_gan_tpu_torch.ops.cg import conjugate_gradient
from dl_swin_gan_tpu_torch.ops.sense import SenseOp
from dl_swin_gan_tpu_torch.solvers.unrolled import (
    _DC_MODE_FROM_META, _checkpoint_replaying_dropout,
)


class DiffusionUnrolled(nn.Module):
    """model(x0, t, A=..., A_1=..., A_F=..., A_S=..., fs=..., c=...), the
    reference's model_kwargs protocol: the SenseOps and the labels c come
    as keywords; A_S and fs are accepted and unused."""

    def __init__(self, make_denoiser: Callable[[bool], nn.Module],
                 num_unrolls: int = 4, dc_mode: str = "dc",
                 share_weights: bool = False, fix_step_size: bool = False,
                 learn_sigma: bool = False, num_cg_steps: int = 10,
                 remat: bool = False):
        super().__init__()
        if dc_mode not in ("none", "ddpm", "dc", "pgd", "hqs"):
            raise ValueError(f"Unknown dc_mode: {dc_mode}")
        self.num_unrolls = num_unrolls
        self.dc_mode = dc_mode
        self.share_weights = share_weights
        self.fix_step_size = fix_step_size
        self.learn_sigma = learn_sigma
        self.num_cg_steps = num_cg_steps
        self.remat = remat
        # the ranks of a data-parallel batch's other slices: the hqs CG's
        # inner products sum over them (set by the trainer)
        self.batch_group = None
        n_nets = 1 if share_weights else num_unrolls
        nets = [make_denoiser(learn_sigma and not share_weights
                              and i == n_nets - 1) for i in range(n_nets)]
        if learn_sigma and share_weights:
            nets.append(make_denoiser(True))
        self.nets = nn.ModuleList(nets)
        if dc_mode == "pgd":
            self.step_size = nn.Parameter(torch.full((1,), -2.0))
        elif dc_mode == "hqs":
            self.lamda = nn.Parameter(torch.full((1,), 0.1))

    def _scalar(self, p: torch.Tensor) -> torch.Tensor:
        return (p.detach() if self.fix_step_size else p)[0]

    def _net(self, i: int) -> nn.Module:
        if not self.share_weights:
            return self.nets[i]
        last = self.learn_sigma and i == self.num_unrolls - 1
        return self.nets[-1] if last else self.nets[0]

    def _denoise(self, i, v, t, c):
        net = self._net(i)
        if self.remat and torch.is_grad_enabled():
            return _checkpoint_replaying_dropout(net, v, t, c)
        return net(v, t, c)

    def forward(self, x0, t, A=None, A_1=None, A_F=None, A_S=None, fs=None,
                c=None):
        x = x0
        if self.dc_mode in ("none", "ddpm"):
            for i in range(self.num_unrolls):
                x = self._denoise(i, x, t, c)
        elif self.dc_mode == "dc":
            acquired = A(x0)
            for i in range(self.num_unrolls):
                x = self._denoise(i, x, t, c)
                x = A_F(A_1(x) + acquired, adjoint=True)
        elif self.dc_mode == "pgd":
            eta = self._scalar(self.step_size)
            for i in range(self.num_unrolls):
                x = x + eta * (A(A(x), adjoint=True) - x0)
                x = self._denoise(i, x, t, c)
        else:
            mu = self._scalar(self.lamda)

            def normal(m):
                return A(A(m), adjoint=True) + mu * m

            for i in range(self.num_unrolls):
                z = self._denoise(i, x, t, c)
                x = conjugate_gradient(normal, x, x0 + mu * z,
                                       self.num_cg_steps, self.batch_group)
        return x


def model_kwargs(maps, dc_mask, target=None, mask_r=None) -> dict:
    """The reference's model_kwargs: the SenseOps A (dc_mask), A_1 (its
    complement), A_F (no mask) and A_S, the target fs and the labels c (all
    ones)."""
    return dict(A=SenseOp(maps, dc_mask), A_1=SenseOp(maps, 1.0 - dc_mask),
                A_F=SenseOp(maps, None),
                A_S=SenseOp(maps, dc_mask if mask_r is None else mask_r),
                fs=target,
                c=torch.ones((maps.shape[0],), dtype=torch.long,
                             device=maps.device))


def make_denoiser_factory(cfg, generator: Optional[torch.Generator] = None
                          ) -> Callable[[bool], nn.Module]:
    """(learn_sigma) -> the config's diffusion backbone, with
    MODEL.PARAMETERS.LEARN_SIGMA set to it; weights from `generator`."""
    from dl_swin_gan_tpu_torch.models import build_denoiser

    def factory(learn_sigma: bool) -> nn.Module:
        c = cfg.clone()
        c.defrost()
        c.MODEL.PARAMETERS.LEARN_SIGMA = learn_sigma
        c.freeze()
        return build_denoiser(c, generator)

    return factory


def build_diffusion_solver(cfg, generator: Optional[torch.Generator] = None
                           ) -> DiffusionUnrolled:
    """The diffusion solver of a config: META_ARCHITECTURE picks the rule
    (DDPM_X dc, DDPM_E none, dlespirit pgd, modl hqs, and the port's
    aliases), MODEL_TYPE the backbone."""
    p = cfg.MODEL.PARAMETERS
    meta = cfg.MODEL.META_ARCHITECTURE.lower()
    if meta not in _DC_MODE_FROM_META:
        raise ValueError(f"Unknown META_ARCHITECTURE: {meta}")
    return DiffusionUnrolled(
        make_denoiser=make_denoiser_factory(cfg, generator),
        num_unrolls=p.NUM_UNROLLS,
        dc_mode=_DC_MODE_FROM_META[meta],
        share_weights=p.SHARE_WEIGHTS,
        fix_step_size=p.FIX_STEP_SIZE,
        learn_sigma=p.LEARN_SIGMA,
        num_cg_steps=p.MODL.NUM_CG_STEPS,
        remat=p.GRAD_CHECKPOINT,
    )
