"""Complex and magnitude image metrics and losses, on torch tensors.

Counterpart of `ops/metrics.py` in the JAX package (itself the reference's
`dl_cs/utils/metrics.py:11-153`). Differentiable; the training losses are
drawn from these by `train/losses.py`.
"""

import torch


def calc_weight(ref: torch.Tensor) -> torch.Tensor:
    """Through-time standard-deviation weighting, ref [N, C, T, Y, X].

    The unbiased (ddof=1) std over T, with the reference's quirk kept on
    purpose: its `repeat_interleave(std, nt, dim=2)` runs on the
    post-reduction dim 2 (Y), and the reshape to ref.shape then maps
    W[..., t, y, x] = std[..., (t*Y + y) // T, x] rather than broadcasting
    the std over T."""
    nt = ref.shape[2]
    std = torch.std(ref, dim=2, unbiased=True).abs()    # [N, C, Y, X]
    return std.repeat_interleave(nt, dim=2).reshape(ref.shape)


def _weight(ref: torch.Tensor, weight: bool) -> torch.Tensor:
    if weight:
        return calc_weight(ref)
    return torch.ones(ref.shape, dtype=ref.real.dtype, device=ref.device)


def l2(ref: torch.Tensor, pred: torch.Tensor,
       weight: bool = False) -> torch.Tensor:
    """RMS error, optionally temporal-std weighted."""
    W = _weight(ref, weight)
    return torch.sqrt(torch.mean(torch.abs(W * (ref - pred)) ** 2))


def l1(ref: torch.Tensor, pred: torch.Tensor,
       weight: bool = False) -> torch.Tensor:
    """Mean absolute error."""
    W = _weight(ref, weight)
    return torch.mean(torch.abs(W * (ref - pred)))


def psnr(ref: torch.Tensor, pred: torch.Tensor,
         weight: bool = False) -> torch.Tensor:
    """20 log10(max|ref| / l2)."""
    scale = torch.abs(ref).max()
    return 20 * torch.log10(scale / l2(ref, pred, weight))


def perp_loss(ref: torch.Tensor, pred: torch.Tensor,
              weight: bool = False) -> torch.Tensor:
    """Perpendicular complex loss (Terpstra et al., ISMRM 2021): the
    normalised absolute cross product of pred and ref plus a magnitude L1
    term."""
    W = _weight(ref, weight)
    P = (torch.abs(W * pred.real * ref.imag - W * pred.imag * ref.real)
         / torch.abs(W * ref))
    M = torch.abs(torch.abs(W * ref) - torch.abs(W * pred))
    return torch.mean(P + M)
