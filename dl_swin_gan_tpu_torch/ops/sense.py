"""SENSE forward / adjoint / normal operators.

Counterpart of `ops/sense.py` in the JAX package. The forward model is
    y = W . F . S x        (image -> masked multicoil k-space)
and the adjoint
    x = S^H . F^H . W y    (masked k-space -> coil-combined image)

Shapes, as in the JAX package:
    x     [B, E, T, Y, X]      complex64  (E = ESPIRiT maps)
    y     [B, C, T, Y, X]      complex64  (C = coils)
    maps  [B, E, C, 1, Y, X]   complex64
    mask  [B, 1|C, T, Y, X]    float32 or None (sampling weights W)

The normal operator A^H W^2 A goes through the SENSE-normal kernel wrapper
whenever the maps have one set dim and the mask is shared across coils (the
JAX package's dispatch rule); other shapes take the `torch.fft` chain.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from dl_swin_gan_tpu_torch.kernels import sense_normal as _kernel
from dl_swin_gan_tpu_torch.ops.fft import fftc, ifftc


def _forward_impl(x, maps, mask):
    """x [B, E, T, Y, X], maps [B, E, C, 1, Y, X] -> y [B, C, T, Y, X]."""
    coil_ims = (x.unsqueeze(2) * maps).sum(1)
    ksp = fftc(coil_ims, ndims=2)
    if mask is not None:
        ksp = ksp * mask
    return ksp


def _adjoint_impl(y, maps, mask):
    if mask is not None:
        y = y * mask
    coil_ims = ifftc(y, ndims=2)
    return (coil_ims.unsqueeze(1) * maps.conj()).sum(2)


def sense_forward(x: torch.Tensor, maps: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image -> masked multicoil k-space: y = W*F(sum_e maps_e * x_e)."""
    return _forward_impl(x, maps, mask)


def sense_adjoint(y: torch.Tensor, maps: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked k-space -> image: x = sum_c conj(maps_c) * F^H(W*y)."""
    return _adjoint_impl(y, maps, mask)


def _normal_fusable(x, maps, mask) -> bool:
    return (x.ndim == 5 and maps.ndim == 6 and maps.shape[3] == 1
            and (mask is None or (mask.ndim == 5 and mask.shape[1] == 1)))


def _normal_impl(x, maps, mask):
    """A^H W^2 A x: the kernel wrapper for fusable shapes (the forward masks
    once and the adjoint again, so the kernel weights k-space by mask^2),
    the FFT chain otherwise."""
    if not _normal_fusable(x, maps, mask):
        return _adjoint_impl(_forward_impl(x, maps, mask), maps, mask)
    B, E, T, Y, X = x.shape
    m = maps[:, :, :, 0].contiguous()                    # [B, E, C, Y, X]
    if mask is None:
        w = torch.ones((B, T, Y, X), dtype=torch.float32, device=x.device)
    else:
        w = mask[:, 0].to(torch.float32).expand(B, T, Y, X)
        w = w * w
    return _kernel.sense_normal(x.contiguous(), m, w.contiguous())


class _SenseNormal(torch.autograd.Function):
    """N = A^H W^2 A is self-adjoint. PyTorch's complex autograd passes the
    conjugate Wirtinger cotangent and wants N^H g back, which is N(g)
    itself, through the same dispatch (the JAX rule conj(N(conj g)) is the
    same map under JAX's convention)."""

    @staticmethod
    def forward(ctx, x, maps, mask):
        ctx.maps, ctx.mask = maps, mask
        return _normal_impl(x, maps, mask)

    @staticmethod
    def backward(ctx, g):
        return _normal_impl(g, ctx.maps, ctx.mask), None, None


def sense_normal(x: torch.Tensor, maps: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normal operator A^H W^2 A x (the PGD/CG hot loop)."""
    return _SenseNormal.apply(x, maps, mask)


@dataclass(frozen=True)
class SenseOp:
    """Callable SENSE operator closed over (maps, mask): `A(x)` is the
    forward op, `A(y, adjoint=True)` the adjoint, `A.normal(x)` A^H A."""
    maps: torch.Tensor
    mask: Optional[torch.Tensor] = None

    def __call__(self, data: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
        if adjoint:
            return sense_adjoint(data, self.maps, self.mask)
        return sense_forward(data, self.maps, self.mask)

    def normal(self, x: torch.Tensor) -> torch.Tensor:
        return sense_normal(x, self.maps, self.mask)
