"""Plain PyTorch MRI operators and input preparation of the reference.

Written from the semantics of the original dl-swin-gan code (SENSE with
ESPIRiT maps, fftmod'ed k-space, time-averaged normalisation, sliding-window
init, the training crop and flips) and not from the program: it imports
nothing of it. Layouts:

    x     [B, E, T, Y, X] complex   image, E ESPIRiT maps
    y     [B, C, T, Y, X] complex   multicoil k-space (DC at N/2: fftmod'ed)
    maps  [B, E, C, 1, Y, X] complex
    mask  [B, 1, T, Y, X] float     sampling weights
"""

from typing import Dict

import numpy as np
import torch

from benchmark.reference.vdkt import VDktMaskFunc


def fft2(x: torch.Tensor) -> torch.Tensor:
    """Unitary 2D DFT over the last two axes (no shifts: fftmod storage)."""
    return torch.fft.fftn(x, dim=(-2, -1), norm="ortho")


def ifft2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftn(x, dim=(-2, -1), norm="ortho")


def sense_forward(x, maps, mask=None):
    """y = W F (sum_e maps_e x_e)."""
    y = fft2((x.unsqueeze(2) * maps).sum(1))
    return y if mask is None else y * mask


def sense_adjoint(y, maps, mask=None):
    """x = sum_c conj(maps_c) F^H (W y)."""
    if mask is not None:
        y = y * mask
    return (ifft2(y).unsqueeze(1) * maps.conj()).sum(2)


def sense_normal(x, maps, mask):
    """A^H A x: the weights apply once in each direction (W^2)."""
    return sense_adjoint(sense_forward(x, maps, mask), maps, mask)


def time_average(y: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean of the acquired (nonzero) samples over `dim`, kept as size 1."""
    acquired = (y.abs() > 1e-12).to(y.real.dtype)
    return y.sum(dim, keepdim=True) / (acquired.sum(dim, keepdim=True) + 1e-6)


def sliding_window(y: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """Frame i: the time average of the `width` frames centred on it,
    circularly (view sharing)."""
    n = y.shape[dim]
    frames = []
    for i in range(n):
        rolled = torch.roll(y, width // 2 - i, dims=dim)
        frames.append(time_average(rolled.narrow(dim, 0, width), dim))
    return torch.cat(frames, dim)


def kth_largest_scale(image: torch.Tensor) -> torch.Tensor:
    """Per example: the k-th largest magnitude, k = round(5 % of the
    elements): the 95th-percentile normalisation without interpolation.
    Returns [B]."""
    mag = image.abs().reshape(image.shape[0], -1)
    k = int(round(0.05 * mag.shape[1]))
    if k == 0:
        return mag.amax(1)
    return torch.topk(mag, k, dim=1).values[:, -1]


def normalise_and_init(masked, maps):
    """(scaled k-space, init image, scale [B]): the time-averaged adjoint's
    95th percentile divides the k-space, and the init is the adjoint of its
    5-frame sliding-window average."""
    scale = kth_largest_scale(sense_adjoint(time_average(masked, 2), maps))
    masked = masked / scale.reshape(-1, 1, 1, 1, 1)
    return masked, sense_adjoint(sliding_window(masked, 2, 5), maps), scale


# -- training: the batch build ---------------------------------------------

def build_example(kspace, maps, params, crop_readout: int) -> Dict:
    """One training example [1, ...] from raw k-space [C, T, Y, X] and maps
    [E, C, 1, Y, X] (complex, on any device): crop the readout, flip x, y
    and time in the image domain, SENSE-adjoint target, mask, normalise,
    sliding-window init."""
    coil_images = ifft2(kspace[None])
    maps = maps[None]
    if crop_readout > 0:
        xs = params["xs"]
        coil_images = coil_images[..., xs:xs + crop_readout]
        maps = maps[..., xs:xs + crop_readout]
    fx, fy, ft = params["flips"]
    if fx:
        coil_images, maps = coil_images.flip(-1), maps.flip(-1)
    if fy:
        coil_images, maps = coil_images.flip(-2), maps.flip(-2)
    if ft:
        coil_images = coil_images.flip(-3)
    full = fft2(coil_images)
    target = sense_adjoint(full, maps)
    mask = torch.as_tensor(params["mask"], dtype=torch.float32,
                           device=kspace.device)[None, None]
    masked, init, scale = normalise_and_init(full * mask, maps)
    return dict(kspace=masked, maps=maps, mask=mask, init_image=init,
                target=target / scale.reshape(-1, 1, 1, 1, 1),
                scale=scale.to(torch.float32))


# -- serving -----------------------------------------------------------------

def serving_mask(shape, acceleration: float, seed: int, partial_kx: float,
                 partial_ky: float) -> np.ndarray:
    """The serving protocol's mask [T, Y, X]: VDkt at one fixed
    acceleration and seed."""
    T, Y, X = shape
    fn = VDktMaskFunc((acceleration, acceleration), partial_kx, partial_ky)
    return fn((1, 1, T, Y, X), seed).reshape(T, Y, X)
