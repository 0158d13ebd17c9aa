"""The benchmark's input generator: cine MRI slices made on the device.

A slice is a beating-heart phantom (static body and ring, a left ventricle
whose radius follows the cardiac cycle, a myocardial wall, a smooth phase)
seen by C smooth coils and stored as the datasets store it: fully sampled
k-space, F applied to the centred coil images and fftmod'ed (DC at N/2),
and two ESPIRiT-like maps (the coil set and a weak shifted copy). Every
random quantity comes from one `torch.Generator` on the device, drawn in a
few large calls, so that a pool of slices costs milliseconds and the same
seed gives the same slices.
"""

import math
from typing import Dict

import torch


def _grid(Y: int, X: int, device):
    yy = torch.arange(Y, device=device, dtype=torch.float32).reshape(Y, 1)
    xx = torch.arange(X, device=device, dtype=torch.float32).reshape(1, X)
    return yy, xx


def _fftmod(k: torch.Tensor) -> torch.Tensor:
    Y, X = k.shape[-2:]
    yy, xx = _grid(Y, X, k.device)
    sign = 1.0 - 2.0 * torch.remainder(yy + xx + 1, 2)
    return k * sign


def make_slices(n: int, geometry: Dict[str, int], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """n raw slices: kspace [n, C, T, Y, X] and maps [n, E, C, 1, Y, X],
    complex64 on `device`."""
    T, Y, X, C, E = (geometry[k] for k in ("T", "Y", "X", "C", "E"))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    u = torch.rand((n, 8 + 3 * C), generator=gen, device=device)
    yy, xx = _grid(Y, X, device)
    yy, xx = yy[None], xx[None]                             # [1, Y, 1]...

    # anatomy [n, T, Y, X]
    body = torch.exp(-(((yy - Y / 2) / (0.45 * Y)) ** 2
                       + ((xx - X / 2) / (0.45 * X)) ** 2) * 2.0)
    ring = ((torch.sqrt((yy - Y / 2) ** 2 + (xx - X / 2) ** 2)
             - 0.30 * min(Y, X)).abs() < 2.5).float()
    cy = (Y * (0.42 + 0.16 * u[:, 0])).reshape(n, 1, 1, 1)
    cx = (X * (0.42 + 0.16 * u[:, 1])).reshape(n, 1, 1, 1)
    phase0 = 2 * math.pi * u[:, 2].reshape(n, 1, 1, 1)
    t = torch.arange(T, device=device, dtype=torch.float32).reshape(1, T, 1, 1)
    radius = (0.10 + 0.03 * u[:, 3].reshape(n, 1, 1, 1)
              + 0.04 * torch.sin(2 * math.pi * t / T + phase0)) * min(Y, X)
    dist = torch.sqrt((yy[:, None] - cy) ** 2 + (xx[:, None] - cx) ** 2)
    lv = (dist < radius).float()
    wall = ((dist - radius).abs() < 3).float()
    gain = (0.8 + 0.4 * u[:, 4]).reshape(n, 1, 1, 1)
    img = gain * (0.4 * body + 0.3 * ring)[:, None] + lv + 0.6 * wall
    bg = (0.1 + 0.1 * u[:, 5]).reshape(n, 1, 1, 1) * xx[:, None] / X \
        + (0.05 + 0.1 * u[:, 6]).reshape(n, 1, 1, 1) * yy[:, None] / Y
    img = torch.polar(img, bg.expand_as(img))

    # coils [n, C, Y, X], sum |s|^2 = 1
    c = torch.arange(C, device=device, dtype=torch.float32).reshape(1, C)
    ang = 2 * math.pi * c / C + 0.3 * (u[:, 7:8] - 0.5)
    jit = u[:, 8:8 + 2 * C].reshape(n, C, 2)
    sy = (Y / 2 + 0.55 * Y * torch.sin(ang) * (0.8 + 0.4 * jit[..., 0])
          ).reshape(n, C, 1, 1)
    sx = (X / 2 + 0.55 * X * torch.cos(ang) * (0.8 + 0.4 * jit[..., 1])
          ).reshape(n, C, 1, 1)
    mag = torch.exp(-(((yy[:, None] - sy) / Y) ** 2
                      + ((xx[:, None] - sx) / X) ** 2) * 3.0)
    ph = (2 * math.pi * u[:, 8 + 2 * C:8 + 3 * C].reshape(n, C, 1, 1)
          + 0.5 * ((yy[:, None] - sy) / Y + (xx[:, None] - sx) / X))
    coils = torch.polar(mag, ph)
    coils = coils / (torch.sqrt((coils.abs() ** 2).sum(1, keepdim=True))
                     + 1e-8)

    coil_images = coils[:, :, None] * img[:, None]          # [n, C, T, Y, X]
    k = torch.fft.fftshift(torch.fft.fft2(
        torch.fft.ifftshift(coil_images, dim=(-2, -1)), norm="ortho"),
        dim=(-2, -1))
    kspace = _fftmod(k).to(torch.complex64)
    maps = torch.zeros((n, E, C, 1, Y, X), dtype=torch.complex64,
                       device=device)
    maps[:, 0, :, 0] = coils
    if E > 1:
        maps[:, 1, :, 0] = 0.05 * torch.roll(coils, Y // 4, dims=-2)
    return dict(kspace=kspace, maps=maps)
