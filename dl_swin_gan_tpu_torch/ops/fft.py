"""Uncentered, ortho-normalized 2D FFTs over the trailing axes, and fftmod.

Counterpart of `ops/fft.py` in the JAX package (its `jnp.fft` branch) on
`torch.fft`. The operator layout is [..., t, y, x]; k-space is stored
fftmod'ed (DC at N/2), so no shifts are needed on the hot path.
"""

import torch


def _axes(ndims: int) -> tuple:
    return tuple(range(-ndims, 0))


def fftc(data: torch.Tensor, ndims: int = 2, norm: str = "ortho",
         centered: bool = False) -> torch.Tensor:
    """Forward FFT over the trailing `ndims` axes (ifftshift/fftshift
    sandwich when `centered`)."""
    dims = _axes(ndims)
    if centered:
        data = torch.fft.ifftshift(data, dim=dims)
    data = torch.fft.fftn(data, dim=dims, norm=norm)
    if centered:
        data = torch.fft.fftshift(data, dim=dims)
    return data


def ifftc(data: torch.Tensor, ndims: int = 2, norm: str = "ortho",
          centered: bool = False) -> torch.Tensor:
    """Inverse FFT over the trailing `ndims` axes."""
    dims = _axes(ndims)
    if centered:
        data = torch.fft.ifftshift(data, dim=dims)
    data = torch.fft.ifftn(data, dim=dims, norm=norm)
    if centered:
        data = torch.fft.fftshift(data, dim=dims)
    return data


def fftmod(data: torch.Tensor) -> torch.Tensor:
    """Checkerboard modulation: multiply element (y, x) by (-1)^(x + y + 1),
    so FFT shifts can be skipped."""
    ny, nx = data.shape[-2], data.shape[-1]
    iy = torch.arange(ny, device=data.device).reshape(ny, 1)
    ix = torch.arange(nx, device=data.device).reshape(1, nx)
    real = data.real.dtype if data.is_complex() else data.dtype
    sign = 1.0 - 2.0 * ((iy + ix + 1) % 2).to(real)
    return data * sign
