"""Unrolled meta-architectures: the SENSE-unrolled solver composed with a
denoiser backbone, the diffusion solver composed with a (t, c)-conditioned
backbone, and the DSLR low-rank solver."""

from typing import Optional

import torch

from dl_swin_gan_tpu_torch.models import DIFFUSION_MODELS
from dl_swin_gan_tpu_torch.solvers.diffusion_unrolled import (
    DiffusionUnrolled, build_diffusion_solver,
)
from dl_swin_gan_tpu_torch.solvers.dslr import (
    DSLR_MODES, UnrolledLR, build_dslr_solver,
)
from dl_swin_gan_tpu_torch.solvers.unrolled import UnrolledSolver, build_solver


def build_model(cfg, generator: Optional[torch.Generator] = None):
    """The solver the config describes: a DSLR `UnrolledLR` when
    META_ARCHITECTURE names a DSLR mode, a `DiffusionUnrolled` when
    MODEL_TYPE is a diffusion backbone (DIT, LATTE, SWIN_DIFF), else an
    `UnrolledSolver`; `generator` seeds its weights."""
    if cfg.MODEL.META_ARCHITECTURE.lower() in DSLR_MODES:
        return build_dslr_solver(cfg, generator=generator)
    if cfg.MODEL.MODEL_TYPE.upper() in DIFFUSION_MODELS:
        return build_diffusion_solver(cfg, generator=generator)
    return build_solver(cfg, generator=generator)
