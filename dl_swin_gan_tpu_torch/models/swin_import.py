"""Pretrained weights for the video Swin trunk: 2D -> 3D inflation.

Counterpart of `models/swin_import.py` in the JAX package (the reference's
`inflate_weights`, `video_swin_transformer_mri_downsample.py:651-700`):
a 3D `SwinTransformer3D` trunk starts from a 2D Swin checkpoint (the
official microsoft/Swin key schema) by

- inflating `patch_embed.proj.weight` across the temporal patch axis
  (repeated `patch_t` times, divided by `patch_t`);
- resizing each `relative_position_bias_table` bicubically from the 2D
  window's (2w-1)^2 offsets to the 3D window's (2*ws1-1)*(2*ws2-1) when they
  differ, then tiling it over the (2*ws0-1) temporal offsets (the 3D table
  is temporal-major, `models/swin.py`);
- copying the blocks' tensors into the trunk's parameters, skipping and
  reporting any whose shape differs (the reference loads with
  strict=False; a shape mismatch, which torch would raise on, keeps the
  trunk's own value, as in the JAX package).

The checkpoint and the port's trunk are both in torch layout: Linear weights
stay [out, in], and the port's names are the checkpoint's but for
`patch_embed.proj` (the port's `patch_embed` is the conv itself).
"""

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

# a Swin block's checkpoint tensors, by their name under the block; the
# port's block names them the same
_BLOCK_KEYS = ("norm1.weight", "norm1.bias",
               "attn.relative_position_bias_table",
               "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias",
               "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias",
               "mlp.fc2.weight", "mlp.fc2.bias")


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _bicubic_resize_table(table: np.ndarray, out_hw: Tuple[int, int]
                          ) -> np.ndarray:
    """Bicubic resize of a [S1*S1, nH] table to [out_h*out_w, nH]: the
    reference's F.interpolate on [1, nH, S1, S1]."""
    L1, nH = table.shape
    S1 = int(round(L1 ** 0.5))
    t = torch.from_numpy(np.ascontiguousarray(table.astype(np.float32)))
    t = t.permute(1, 0).reshape(1, nH, S1, S1)
    t = F.interpolate(t, size=out_hw, mode="bicubic")
    return t.reshape(nH, out_hw[0] * out_hw[1]).permute(1, 0).numpy()


def inflate_swin2d(state_dict: Dict[str, "np.ndarray"],
                   window_size: Tuple[int, int, int],
                   patch_t: int) -> Dict[str, np.ndarray]:
    """A 2D Swin state_dict inflated to 3D by the reference's rules: a new
    dict of numpy arrays in torch layout, without the relative-position
    index and attention-mask buffers (the trunk derives its own)."""
    sd = {k: _to_np(v) for k, v in state_dict.items()
          if "relative_position_index" not in k and "attn_mask" not in k}

    if "patch_embed.proj.weight" in sd:
        w = sd["patch_embed.proj.weight"]
        if w.ndim == 4:  # [E, C, kh, kw] -> [E, C, kt, kh, kw]
            sd["patch_embed.proj.weight"] = (
                np.repeat(w[:, :, None], patch_t, axis=2) / patch_t)

    wt, wh, ww = window_size
    L2 = (2 * wh - 1) * (2 * ww - 1)
    for k in [k for k in sd if "relative_position_bias_table" in k]:
        tab = sd[k]
        if tab.shape[0] != L2:
            tab = _bicubic_resize_table(tab, (2 * wh - 1, 2 * ww - 1))
        sd[k] = np.tile(tab, (2 * wt - 1, 1))
    return sd


def _set(params: Dict[str, torch.Tensor], name: str, value: np.ndarray,
         report: dict, torch_key: str) -> None:
    if name not in params:
        report["missing"].append(name)
        return
    param = params[name]
    if tuple(param.shape) != tuple(value.shape):
        logger.warning("swin import: shape mismatch for %s (%s vs %s), "
                       "keeping init", torch_key, tuple(value.shape),
                       tuple(param.shape))
        report["skipped"].append(torch_key)
        return
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    report["loaded"].append(torch_key)


def apply_swin_state_dict(trunk: torch.nn.Module, sd: Dict[str, np.ndarray],
                          stage_map: Optional[Dict[int, int]] = None) -> dict:
    """Copy an inflated, torch-layout Swin state_dict into the parameters of
    a `SwinTransformer3D` trunk in place; returns the {loaded, skipped,
    missing} report (checkpoint keys loaded or skipped, the trunk's names
    missing).

    stage_map maps the trunk's BasicLayer index to the checkpoint's
    `layers.<i>` (identity by default), so, for example, ImageNet Swin-T's
    depth-6 stage 2 can seed the MRI wrapper's one depth-6 stage.
    """
    params = dict(trunk.named_parameters())
    report = {"loaded": [], "skipped": [], "missing": []}
    for key in ("weight", "bias"):
        if f"patch_embed.proj.{key}" in sd:
            _set(params, f"patch_embed.{key}", sd[f"patch_embed.proj.{key}"],
                 report, f"patch_embed.proj.{key}")

    stages = {int(k.split(".")[1]) for k in sd if k.startswith("layers.")}
    ours = sorted({int(k.split(".")[1]) for k in params
                   if k.startswith("layers.")})
    stage_map = stage_map or {i: i for i in ours}
    for i in ours:
        theirs = stage_map.get(i)
        if theirs is None or theirs not in stages:
            continue
        blocks = {int(k.split(".")[3]) for k in sd
                  if k.startswith(f"layers.{theirs}.blocks.")}
        our_blocks = sorted({int(k.split(".")[3]) for k in params
                             if k.startswith(f"layers.{i}.blocks.")})
        for j in our_blocks:
            if j not in blocks:
                continue
            for suffix in _BLOCK_KEYS:
                key = f"layers.{theirs}.blocks.{j}.{suffix}"
                if key in sd:
                    _set(params, f"layers.{i}.blocks.{j}.{suffix}", sd[key],
                         report, key)
        down = f"layers.{theirs}.downsample"
        if (f"{down}.reduction.weight" in sd
                and f"layers.{i}.downsample.reduction.weight" in params):
            for suffix in ("norm.weight", "norm.bias", "reduction.weight"):
                _set(params, f"layers.{i}.downsample.{suffix}",
                     sd[f"{down}.{suffix}"], report, f"{down}.{suffix}")
    return report


def load_checkpoint_file(path: str) -> Dict[str, np.ndarray]:
    """A 2D Swin checkpoint: a torch .pth (official releases wrap the
    weights under 'model' or 'state_dict') or a converted .npz."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "module"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: _to_np(v) for k, v in ckpt.items()}


def import_swin2d_checkpoint(trunk: torch.nn.Module, path: str,
                             window_size: Tuple[int, int, int],
                             patch_t: int,
                             stage_map: Optional[Dict[int, int]] = None
                             ) -> dict:
    """Load, inflate (2D -> 3D) and copy into `trunk` in place; returns the
    report."""
    sd = inflate_swin2d(load_checkpoint_file(path), window_size, patch_t)
    report = apply_swin_state_dict(trunk, sd, stage_map=stage_map)
    logger.info("swin 2D->3D import from %s: %d loaded, %d skipped, "
                "%d missing", path, len(report["loaded"]),
                len(report["skipped"]), len(report["missing"]))
    return report
