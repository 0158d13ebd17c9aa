"""Metric dictionary and training-loss dispatch.

Counterpart of `train/losses.py` in the JAX package (the reference's
`scripts/train.py:46-71`): complex and magnitude L1/L2/PSNR with optional
temporal-std weighting; the training loss is picked from the dict by
MODEL.RECON_LOSS.NAME. With a `perceptual` loss (train/perceptual.py) the
dict also holds complex_vggloss and mag_vggloss, as the reference adds them
only when one is the training loss.
"""

from typing import Dict

import torch

from dl_swin_gan_tpu_torch.ops import metrics as M


def compute_metrics(prediction: torch.Tensor, target: torch.Tensor,
                    weight: bool = False, tag: str = "Train",
                    perceptual=None) -> Dict[str, torch.Tensor]:
    out = {
        f"{tag}/complex_l1": M.l1(target, prediction, weight),
        f"{tag}/complex_l2": M.l2(target, prediction, weight),
        f"{tag}/complex_psnr": M.psnr(target, prediction, weight),
    }
    mp, mt = torch.abs(prediction), torch.abs(target)
    out[f"{tag}/mag_l1"] = M.l1(mt, mp, weight)
    out[f"{tag}/mag_l2"] = M.l2(mt, mp, weight)
    out[f"{tag}/mag_psnr"] = M.psnr(mt, mp, weight)
    if perceptual is not None:
        out[f"{tag}/complex_vggloss"] = perceptual(target, prediction)
        out[f"{tag}/mag_vggloss"] = perceptual(mt, mp)
    return out


def select_loss(metrics: Dict[str, torch.Tensor], loss_name: str,
                tag: str = "Train") -> torch.Tensor:
    key = f"{tag}/{loss_name}"
    if key not in metrics:
        raise ValueError(f"Unknown RECON_LOSS.NAME '{loss_name}'; "
                         f"available: {sorted(metrics)}")
    return metrics[key]
