"""Bidirectional LSTM over time for a complex 1-D basis.

Counterpart of `models/rnn.py` in the JAX package (the reference's
`dl_cs/models/rnn.py`): complex [N, T, C] packed as interleaved (re, im)
features [N, T, 2C], a stacked LSTM (bidirectional: each layer's forward
and time-reversed outputs concatenated and fed to the next, which is what
flax's `nn.RNN` pair with `reverse=True, keep_order=True` computes), then a
Linear back to 2C features, repacked complex. The LSTM is torch's (cuDNN on
the card): the JAX package runs its cell outside any Pallas kernel too.

The weights are drawn as flax draws them (`flax.linen.LSTMCell` and
`Dense` defaults): each gate's input kernel lecun-normal (a normal
truncated at two standard deviations, scaled to variance 1 / fan_in) with
no bias, each gate's recurrent kernel orthogonal with a zero bias, the
Linear lecun-normal with a zero bias. torch's LSTM keeps the four gates
(i, f, g, o) stacked in `weight_ih_l{k}`, `weight_hh_l{k}` and the two
biases; the input-side bias stays zero and is not trained, as flax's input
kernels have none (training both would move the gates' bias twice as
fast as flax's Adam does).
"""

from typing import Optional

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: truncated normal of variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class RNN(nn.Module):
    """x [N, T, C] complex -> the same shape. `channels` is C."""

    def __init__(self, channels: int, hidden_size: int = 64,
                 num_layers: int = 3, bidirectional: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm = nn.LSTM(2 * channels, hidden_size, num_layers=num_layers,
                            bidirectional=bidirectional, batch_first=True)
        dirs = 2 if bidirectional else 1
        self.dense = nn.Linear(dirs * hidden_size, 2 * channels)
        H = hidden_size
        with torch.no_grad():
            for name, w in self.lstm.named_parameters():
                if name.startswith("bias"):
                    w.zero_()
                    # flax's cell has one bias per gate: the recurrent one
                    w.requires_grad_(name.startswith("bias_hh"))
                elif name.startswith("weight_ih"):
                    for g in range(4):
                        lecun_normal_(w[g * H:(g + 1) * H], w.shape[1],
                                      generator)
                else:
                    for g in range(4):
                        nn.init.orthogonal_(w[g * H:(g + 1) * H],
                                            generator=generator)
            lecun_normal_(self.dense.weight, dirs * H, generator)
            self.dense.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, T, C = x.shape
        h = torch.stack([x.real, x.imag], dim=-1).reshape(N, T, 2 * C)
        h, _ = self.lstm(h)
        h = self.dense(h).reshape(N, T, C, 2)
        return torch.complex(h[..., 0], h[..., 1])
