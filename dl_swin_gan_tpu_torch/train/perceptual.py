"""VGG16 perceptual loss.

Counterpart of `train/perceptual.py` in the JAX package (the reference's
`dl_cs/utils/VGGloss.py` with `metrics.vggloss`): the VGG16 conv stack up to
its third max-pool, the outputs of the three pools compared by L1 with the
weights 0.65 / 0.3 / 0.05, after ImageNet normalisation and a bilinear resize
to 224 x 224. Each frame of emap 1 is one image: [re, im, 0] for complex
input, [mag, 0, 0] for magnitudes. The loss is the mean over the N * T frames
times T (the reference sums its per-frame losses over time).

Weights come from a .npz of torchvision's `features.{i}.weight/bias`
(DL_SWIN_GAN_VGG16_NPZ, the JAX package's format). Without one the network
keeps fixed features drawn from a seeded torch-default init and says so in a
warning, as the JAX package does with its own seeded init.

The resize is `F.interpolate(mode="bilinear", align_corners=False)`: every
resize of this repo is an upsample (180, 156, 64 and 48 -> 224), where it
equals `jax.image.resize(..., "bilinear")` (whose antialias only acts on a
downsample). The reference's features are detached, not the prediction's:
the reference's no_grad on the prediction was a bug that zeroed the
training gradient.
"""

import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dl_swin_gan_tpu_torch.models.layers import Conv

logger = logging.getLogger(__name__)

# VGG16 conv plan up to pool3; 'M' = 2x2 max-pool. Taps after each pool.
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M")
TAP_WEIGHTS = (0.65, 0.3, 0.05)
# torchvision's `features` index of each conv in the plan
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RANDOM_SEED = 42


class VGG16Features(nn.Module):
    """VGG16 through pool3; returns the three pool outputs."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        convs, cin = [], 3
        for spec in VGG16_PLAN:
            if spec != "M":
                convs.append(Conv(cin, spec, 3, generator, ndim=2))
                cin = spec
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, convs = [], iter(self.convs)
        for spec in VGG16_PLAN:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                taps.append(x)
            else:
                x = F.relu(next(convs)(x))
        return taps

    def load_npz(self, path: str) -> None:
        data = np.load(path)
        with torch.no_grad():
            for conv, i in zip(self.convs, TORCHVISION_CONVS):
                conv.weight.copy_(torch.from_numpy(
                    data[f"features.{i}.weight"].astype(np.float32)))
                conv.bias.copy_(torch.from_numpy(
                    data[f"features.{i}.bias"].astype(np.float32)))


class PerceptualLoss:
    """vggloss(ref, pred) on the device the network is moved to."""

    def __init__(self, weights_npz: Optional[str] = None, resize: bool = True,
                 device=None):
        self.resize = resize
        self.model = VGG16Features(
            torch.Generator().manual_seed(RANDOM_SEED))
        path = weights_npz or os.environ.get("DL_SWIN_GAN_VGG16_NPZ")
        self.pretrained = bool(path and os.path.exists(path))
        if self.pretrained:
            self.model.load_npz(path)
            logger.info("loaded VGG16 weights from %s", path)
        else:
            logger.warning(
                "no pretrained VGG16 weights; using fixed random features "
                "(set DL_SWIN_GAN_VGG16_NPZ to a torchvision vgg16 .npz)")
        self.model.requires_grad_(False).eval().to(device)
        self.mean = torch.tensor(IMAGENET_MEAN, device=device).reshape(3, 1, 1)
        self.std = torch.tensor(IMAGENET_STD, device=device).reshape(3, 1, 1)

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, 3, H, W] in image units -> the tap features."""
        x = (x - self.mean) / self.std
        if self.resize:
            x = F.interpolate(x, size=(224, 224), mode="bilinear",
                              align_corners=False)
        return self.model(x)

    def __call__(self, ref: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """ref, pred: [N, E, T, Y, X], complex or real magnitudes."""
        emap = min(1, ref.shape[1] - 1)
        r, p = ref[:, emap], pred[:, emap]              # [N, T, Y, X]

        def to_rgb(v):
            if v.is_complex():
                x = torch.stack([v.real, v.imag, torch.zeros_like(v.real)], 2)
            else:       # the reference zero-pads two channels: [mag, 0, 0]
                z = torch.zeros_like(v)
                x = torch.stack([v, z, z], 2)
            return x.reshape((-1,) + x.shape[2:])        # [(N T), 3, Y, X]

        loss = 0.0
        for w, a, b in zip(TAP_WEIGHTS, self._features(to_rgb(r)),
                           self._features(to_rgb(p))):
            loss = loss + w * torch.mean(torch.abs(a.detach() - b))
        return loss * r.shape[1]
