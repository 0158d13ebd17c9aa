"""Inference-time preprocessing (host-side numpy).

A copy of `infer/transforms.py` in the JAX package, so both packages feed
their solvers identical batches:
  - InferenceTransform: reconstruct acquired k-space (mask from nonzero
    samples, optional fftmod, 95th-percentile normalization, optional
    sliding-window init);
  - ResampleTransform: re-undersample fully-sampled k-space at a fixed
    acceleration with the parity seed 1000, then the same tail.
"""

import numpy as np

from dl_swin_gan_tpu_torch.data import host_ops as H
from dl_swin_gan_tpu_torch.ops import masks as ss

PARITY_SEED = 1000  # fixed seed used by the reference for eval masks


def _normalize_and_init(kspace, maps, slwin_init: bool):
    """95%-max normalization + optional sliding-window init (shared tail of
    every reference inference transform)."""
    averaged = H.time_average(kspace, axis=2)
    image = H.sense_adjoint(averaged, maps)
    magnitude = np.abs(image).reshape(-1)
    k = int(round(0.05 * magnitude.size))
    scale = np.partition(magnitude, -k)[-k] if k > 0 else magnitude.max()
    kspace = kspace / scale

    if slwin_init:
        init_kspace = H.sliding_window(kspace, axis=2, window_size=5)
    else:
        init_kspace = kspace
    init_image = H.sense_adjoint(init_kspace, maps)
    return kspace, init_image, np.float32(scale)


class InferenceTransform:
    """Reconstruct acquired (already-undersampled or fully-sampled) k-space.

    Args mirror the reference: `apply_fftmod=True` for raw CFL scanner data
    (reconstruct.py:138-140), False for prepared H5 (reconstruct_h5.py:281).
    """

    def __init__(self, config, apply_fftmod: bool = False):
        self.slwin_init = config.MODEL.PARAMETERS.SLWIN_INIT
        self.apply_fftmod = apply_fftmod

    def __call__(self, kspace: np.ndarray, maps: np.ndarray) -> dict:
        kspace = np.asarray(kspace)[None]
        maps = np.asarray(maps)[None]

        mask = H.get_mask(kspace)[:, 0, None]  # [1, 1, T, Y, X]
        if self.apply_fftmod:
            kspace = H.fftmod(kspace)
            maps = H.fftmod(maps)

        kspace, init_image, scale = _normalize_and_init(
            kspace, maps, self.slwin_init)
        return dict(
            kspace=kspace[0].astype(np.complex64),
            mask=mask[0].astype(np.float32),
            maps=maps[0].astype(np.complex64),
            init_image=init_image[0].astype(np.complex64),
            scale=scale,
        )


class ResampleTransform:
    """Re-undersample fully-sampled H5 k-space at a fixed acceleration with
    the parity seed (reconstruct_h5.py:314-368)."""

    def __init__(self, acceleration: float, config, seed: int = PARITY_SEED):
        self.slwin_init = config.MODEL.PARAMETERS.SLWIN_INIT
        self.seed = seed
        self.mask_func = ss.VDktMaskFunc(
            (acceleration, acceleration),
            sim_partial_kx=config.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KX,
            sim_partial_ky=config.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY,
        )

    def __call__(self, kspace: np.ndarray, maps: np.ndarray) -> dict:
        kspace = np.asarray(kspace)[None]
        maps = np.asarray(maps)[None]

        kspace, mask = ss.subsample(kspace, self.mask_func, seed=self.seed,
                                    mode="3D")
        kspace, init_image, scale = _normalize_and_init(
            kspace, maps, self.slwin_init)
        return dict(
            kspace=kspace[0].astype(np.complex64),
            mask=mask[0].astype(np.float32),
            maps=maps[0].astype(np.complex64),
            init_image=init_image[0].astype(np.complex64),
            scale=scale,
        )
