"""3D PatchGAN discriminator on magnitude cine frames.

Counterpart of `models/discriminator.py` in the JAX package: |emap 0| of a
[N, E, T, Y, X] image (or a [N, T, Y, X] magnitude video) -> a (3, 4, 4) conv
with strides (1, 2, 2), then (2, 2, 2) for each later layer, each followed by
a leaky ReLU of slope 0.2, the features doubling up to 8x; then a 3^3 conv,
the leaky ReLU, and a 3^3 conv to one logit per patch, [N, 1, t', y', x'].

flax's padding "SAME" with an even kernel or a stride pads asymmetrically
(TensorFlow's rule: out = ceil(n / s), the total padding
max((out - 1) * s + k - n, 0) split with the smaller half first), which
torch's symmetric `padding=` cannot express: each conv pads with `F.pad` by
that rule, then convolves with no padding of its own. The convs are
float32, with torch's default init from an explicit generator.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dl_swin_gan_tpu_torch.models.layers import _uniform


def same_pads(shape: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]):
    """F.pad's argument (last axis first) for flax/TF SAME padding."""
    pads = []
    for n, k, s in zip(shape, kernel, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


class SameConv3d(nn.Module):
    """3D conv with flax's SAME padding for any kernel and stride."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], strides: Sequence[int] = (1, 1, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        fan_in = in_channels * math.prod(kernel)
        self.weight = _uniform((out_channels, in_channels, *kernel), fan_in,
                               generator)
        self.bias = _uniform((out_channels,), fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, same_pads(x.shape[2:], self.kernel, self.strides))
        return F.conv3d(x, self.weight, self.bias, stride=self.strides)


class PatchDiscriminator3D(nn.Module):
    def __init__(self, features: int = 64, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        convs, cin, feats = [], 1, features
        for i in range(num_layers):
            stride = (1, 2, 2) if i == 0 else (2, 2, 2)
            convs.append(SameConv3d(cin, feats, (3, 4, 4), stride, generator))
            cin, feats = feats, min(feats * 2, 8 * features)
        convs.append(SameConv3d(cin, feats, (3, 3, 3), generator=generator))
        convs.append(SameConv3d(feats, 1, (3, 3, 3), generator=generator))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 5:                 # [N, E, T, Y, X]: |emap 0|
            x = torch.abs(x[:, 0])
        h = x.unsqueeze(1)              # [N, 1, T, Y, X]
        for conv in self.convs[:-1]:
            h = F.leaky_relu(conv(h), 0.2)
        return self.convs[-1](h)
