"""Denoiser backbones: the RES, SE and CBAM trunks (real or complex convs,
full or separable, float32 or a bfloat16 conv trunk), the Swin trunk
(SwinNet3D) and the diffusion backbones DiT, Latte and SwinDiff (they take
(x, t, y) and `solvers/diffusion_unrolled.py` composes them). CONV_BLOCK.DTYPE
reaches every trunk the JAX package's `build_denoiser` passes it to: the
ResNets, Swin, DiT and Latte; SwinDiff takes none there and is float32
here too. The DSLR solver builds its 2D and 1D ResNets itself
(`solvers/dslr.py`).

CONV_BLOCK.NORM is read and, as in the JAX package's `build_denoiser`,
not passed on: a config with NORM 'instance' builds the same trunk as one
with 'none' (ROADMAP.md Queue 3, divergences by design). `layers.normalize`
is reachable by building a ConvBlock directly."""

from typing import Optional

import torch

from dl_swin_gan_tpu_torch.models.cbam import CBAMResNet3D
from dl_swin_gan_tpu_torch.models.layers import DTYPES
from dl_swin_gan_tpu_torch.models.resnet import ResNet3D
from dl_swin_gan_tpu_torch.models.se import SEResNet3D

# MODEL_TYPE -> its ResNet trunk (gate none, se or cbam)
_RESNETS = {"RES": ResNet3D, "SE": SEResNet3D, "CBAM": CBAMResNet3D}
# the diffusion backbones: they take (x, t, y)
DIFFUSION_MODELS = ("DIT", "LATTE", "SWIN_DIFF")


def build_denoiser(cfg, generator: Optional[torch.Generator] = None):
    """Build the denoiser that MODEL.MODEL_TYPE names; `generator` seeds its
    weights. The diffusion backbones take their MODEL.PARAMETERS as the JAX
    package's `build_denoiser` passes them."""
    p = cfg.MODEL.PARAMETERS
    cb = p.CONV_BLOCK
    model_type = cfg.MODEL.MODEL_TYPE.upper()
    if model_type in DIFFUSION_MODELS:
        return _build_diffusion_backbone(cfg, model_type, generator)
    if model_type not in (*_RESNETS, "SWIN"):
        raise ValueError(f"Unknown MODEL_TYPE: {model_type}")
    if cb.COMPLEX and model_type == "SWIN":
        # as in the JAX package: the Swin trunk runs on real/imag channels
        raise NotImplementedError(
            "MODEL_TYPE=SWIN with CONV_BLOCK.COMPLEX=True is not "
            "implemented (nor in the JAX package): the Swin trunk runs on "
            "real/imag channels")
    if str(cb.DTYPE) not in DTYPES:
        raise ValueError(f"Unknown CONV_BLOCK.DTYPE: {cb.DTYPE!r}")
    dtype = DTYPES[str(cb.DTYPE)]
    if model_type == "SWIN":
        from dl_swin_gan_tpu_torch.models.swin import SwinNet3D

        # depths, heads and window as the JAX package's build_denoiser fixes
        # them; the Swin path has no separable or normalised ConvBlocks
        return SwinNet3D(
            num_swinblocks=p.NUM_SWINBLOCKS, depths=(6,), num_heads=(8,),
            window_size=(7, 8, 8), num_emaps=p.NUM_EMAPS,
            num_features=p.NUM_FEATURES, kernel_size=cb.KERNEL_SIZE[0],
            circular_pad=cb.CIRCULAR_PAD, act_type=cb.ACTIVATION,
            generator=generator, dtype=dtype)
    return _RESNETS[model_type](
        num_resblocks=p.NUM_RESBLOCKS, num_emaps=p.NUM_EMAPS,
        num_features=p.NUM_FEATURES, kernel_size=cb.KERNEL_SIZE[0],
        act_type=cb.ACTIVATION, circular_pad=cb.CIRCULAR_PAD,
        generator=generator, use_complex_layers=cb.COMPLEX, dtype=dtype,
        reduction=p.RR, separable=cb.SEPARABLE)


def _build_diffusion_backbone(cfg, model_type: str,
                              generator: Optional[torch.Generator]):
    p = cfg.MODEL.PARAMETERS
    cb = p.CONV_BLOCK
    if str(cb.DTYPE) not in DTYPES:
        raise ValueError(f"Unknown CONV_BLOCK.DTYPE: {cb.DTYPE!r}")
    dtype = DTYPES[str(cb.DTYPE)]
    if model_type == "DIT":
        from dl_swin_gan_tpu_torch.models.dit import DiTResNet
        return DiTResNet(
            num_emaps=p.NUM_EMAPS, hidden_size=p.NUM_FEATURES,
            depth=p.NUM_LAYERS, num_heads=p.NUM_HEADS,
            patch_size=tuple(p.PATCH_SIZE), learn_sigma=p.LEARN_SIGMA,
            num_blocks=p.NUM_RESBLOCKS, circular_pad=cb.CIRCULAR_PAD,
            generator=generator, dtype=dtype)
    if model_type == "LATTE":
        from dl_swin_gan_tpu_torch.models.latte import LatteNet
        return LatteNet(
            num_emaps=p.NUM_EMAPS, hidden_size=p.NUM_FEATURES,
            depth=p.NUM_LAYERS, num_heads=p.NUM_HEADS,
            patch_size=tuple(p.PATCH_SIZE)[-1], learn_sigma=p.LEARN_SIGMA,
            num_blocks=p.NUM_RESBLOCKS, circular_pad=cb.CIRCULAR_PAD,
            generator=generator, dtype=dtype)
    # SwinDiff takes no dtype, as in the JAX package
    from dl_swin_gan_tpu_torch.models.swin_diff import SwinDiffNet
    return SwinDiffNet(
        num_swinblocks=p.NUM_SWINBLOCKS, num_emaps=p.NUM_EMAPS,
        hidden_size=p.NUM_FEATURES, depths=(p.NUM_LAYERS,),
        num_heads=(p.NUM_HEADS,), window_size=(7, 8, 8),
        num_blocks=p.NUM_RESBLOCKS, learn_sigma=p.LEARN_SIGMA,
        circular_pad=cb.CIRCULAR_PAD, generator=generator)
