"""Small k-space / image utilities on torch tensors.

Counterpart of `ops/utils.py` in the JAX package (the reference's
`dl_cs/mri/utils.py:7-79`): the same six functions, on tensors of any
device. `data/device_pipeline.py` builds its time average and
sliding-window init from them.
"""

from typing import Sequence

import torch
import torch.nn.functional as F


def root_sum_of_squares(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """RSS coil combine (`utils.py:22-26`)."""
    return torch.sqrt(torch.sum(x.abs() ** 2, dim=dim))


def get_mask(data: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Recover the sampling mask from nonzero k-space (`utils.py:69-79`)."""
    return (data.abs() > eps).to(torch.float32)


def time_average(data: torch.Tensor, dim: int, eps: float = 1e-6,
                 keepdim: bool = True) -> torch.Tensor:
    """Average acquired (nonzero) samples across `dim` (`utils.py:29-34`)."""
    mask = get_mask(data)
    return (data.sum(dim, keepdim=keepdim)
            / (mask.sum(dim, keepdim=keepdim) + eps))


def sliding_window(data: torch.Tensor, dim: int,
                   window_size: int) -> torch.Tensor:
    """Circular sliding-window view-sharing init (`utils.py:37-49`): for
    each frame i, roll the time axis by window_size // 2 - i, take the first
    `window_size` frames and time-average their acquired samples."""
    nt = data.shape[dim]
    assert 0 < window_size <= nt
    windows = []
    for i in range(nt):
        shifted = torch.roll(data, int(window_size / 2) - i, dims=dim)
        windows.append(time_average(shifted.narrow(dim, 0, window_size), dim))
    return torch.cat(windows, dim=dim)


def center_crop(data: torch.Tensor, shapes: Sequence[int],
                dims: Sequence[int]) -> torch.Tensor:
    """Center crop along the given dims (`utils.py:52-66`)."""
    for size, d in zip(shapes, dims):
        assert 0 < size <= data.shape[d]
        data = data.narrow(d, (data.shape[d] - size) // 2, size)
    return data


def center_pad(data: torch.Tensor, shapes: Sequence[int],
               dims: Sequence[int]) -> torch.Tensor:
    """Zero-pad symmetrically to the target sizes (the inverse of
    center_crop)."""
    pads = [0, 0] * data.ndim          # F.pad's order: last dim first
    for size, d in zip(shapes, dims):
        extra = size - data.shape[d]
        assert extra >= 0
        k = 2 * (data.ndim - 1 - d % data.ndim)
        pads[k], pads[k + 1] = extra // 2, extra - extra // 2
    return F.pad(data, pads)
