"""Training-time cine preprocessing (host-side numpy).

A copy of `data/preprocess.py` in the JAX package (the reference's
`dl_cs/data/preprocess.py:31-180`), run per example in loader threads. The
steps and the RandomState call order are the same, so a seeded example is
bit-identical in both packages:

  1. augmentation: FFT round-trip random crops (readout / phase-encode) and
     random x/y/t flips
  2. target = A^H(kspace)
  3. VDkt undersampling
  4. 95th-percentile magnitude normalisation from the time-averaged
     undersampled k-space
  5. optional sliding-window init
  6. optional locally-low-rank decomposition for DSLR (`lr_decom=True`):
     L_init/R_init from a truncated SVD of the init image's blocks
"""

from typing import Optional

import numpy as np

from dl_swin_gan_tpu_torch.data import host_ops as H
from dl_swin_gan_tpu_torch.ops import masks as ss
from dl_swin_gan_tpu_torch.ops.llr import decompose_init


class CinePreprocess:
    """Maps (kspace, maps, target, fname) -> network-ready example dict.

    Input shapes (one slice, straight from HDF5):
        kspace [C, T, Y, X] complex64
        maps   [E, C, 1, Y, X] complex64
        target [E, T, Y, X] complex64 (recomputed here; passed for API parity)
    """

    def __init__(self, config, aug_node=None, lr_decom: bool = False,
                 use_seed: bool = False, draw_seed: Optional[int] = None,
                 submask: bool = False):
        self.config = config
        self.use_seed = use_seed
        # unseeded training draws, as in the JAX package, unless a draw
        # seed N is given: then the k-th call's crop, flips and mask are
        # seeded from (N, k) (one producer thread calls in order), and with
        # `submask` (DDPM_X) its 90/10 split of the acquired lines too;
        # otherwise the diffusion trainer draws that split per batch
        self.draw_seed = draw_seed
        self.submask = submask
        self.draws = 0
        self.rng = np.random.RandomState()
        aug = aug_node if aug_node is not None else config.AUG_TRAIN
        self.aug = aug
        self.mask_func = ss.VDktMaskFunc(
            aug.UNDERSAMPLE.ACCELERATIONS,
            sim_partial_kx=aug.UNDERSAMPLE.PARTIAL_KX,
            sim_partial_ky=aug.UNDERSAMPLE.PARTIAL_KY,
        )
        self.lr_decom = lr_decom
        p = config.MODEL.PARAMETERS
        self.block_size = p.DSLR.BLOCK_SIZE
        self.num_basis = p.DSLR.NUM_BASIS
        self.overlapping = p.DSLR.OVERLAPPING
        self.slwin_init = p.SLWIN_INIT

    # -- augmentation -------------------------------------------------------
    def _augment(self, kspace, maps, target, seed):
        self.rng.seed(seed)
        multicoil = H.ifft2(kspace)

        crop_size = self.aug.CROP_READOUT
        if crop_size > 0:
            shape_x = multicoil.shape[-1]
            center = int(self.rng.normal(loc=shape_x // 2 + 1, scale=crop_size // 2))
            center = int(np.clip(center, crop_size // 2,
                                 shape_x - crop_size // 2 - 1))
            start = center - crop_size // 2 + 1
            sl = slice(start, start + crop_size)
            multicoil = multicoil[..., sl]
            maps = maps[..., sl]
            target = target[..., sl]

        crop_size_y = self.aug.ZPAD_PE
        if crop_size_y > 0:
            shape_y = multicoil.shape[-2]
            center = int(self.rng.normal(loc=shape_y // 2 + 1, scale=crop_size_y // 2))
            center = int(np.clip(center, crop_size_y // 2,
                                 shape_y - crop_size_y // 2 - 1))
            start = center - crop_size_y // 2 + 1
            sl = slice(start, start + crop_size_y)
            multicoil = multicoil[..., sl, :]
            maps = maps[..., sl, :]
            target = target[..., sl, :]

        if self.rng.rand() > 0.5:  # readout flip
            multicoil = np.flip(multicoil, axis=-1)
            maps = np.flip(maps, axis=-1)
            target = np.flip(target, axis=-1)
        if self.rng.rand() > 0.5:  # phase-encode flip
            multicoil = np.flip(multicoil, axis=-2)
            maps = np.flip(maps, axis=-2)
            target = np.flip(target, axis=-2)
        if self.rng.rand() > 0.5:  # time flip (maps are time-invariant)
            multicoil = np.flip(multicoil, axis=-3)
            target = np.flip(target, axis=-3)

        return H.fft2(multicoil), maps, target

    # -- main ----------------------------------------------------------------
    def __call__(self, kspace, maps, target, fname: str) -> dict:
        seed = None if not self.use_seed else tuple(map(ord, fname))
        keyed = seed is None and self.draw_seed is not None
        if keyed:
            seed = (self.draw_seed, self.draws)
            self.draws += 1

        kspace = np.asarray(kspace)[None]   # [1, C, T, Y, X]
        maps = np.asarray(maps)[None]       # [1, E, C, 1, Y, X]
        target = np.asarray(target)[None]   # [1, E, T, Y, X]

        kspace, maps, target = self._augment(kspace, maps, target, seed)

        # ground truth from the (augmented) fully-sampled k-space
        target = H.sense_adjoint(kspace, maps)

        masked_kspace, mask = ss.subsample(kspace, self.mask_func, seed, mode="3D")

        # 95th-percentile magnitude normalisation
        averaged = H.time_average(masked_kspace, axis=2)
        image = H.sense_adjoint(averaged, maps)
        magnitude = np.abs(image).reshape(-1)
        k = int(round(0.05 * magnitude.size))
        scale = np.partition(magnitude, -k)[-k] if k > 0 else magnitude.max()

        masked_kspace = masked_kspace / scale
        target = target / scale

        if self.slwin_init:
            init_kspace = H.sliding_window(masked_kspace, axis=2, window_size=5)
        else:
            init_kspace = masked_kspace
        init_image = H.sense_adjoint(init_kspace, maps)

        out = dict(
            kspace=np.ascontiguousarray(masked_kspace[0]).astype(np.complex64),
            mask=np.ascontiguousarray(mask[0]).astype(np.float32),
            maps=np.ascontiguousarray(maps[0]).astype(np.complex64),
            init_image=np.ascontiguousarray(init_image[0]).astype(np.complex64),
            scale=np.float32(scale),
            target=np.ascontiguousarray(target[0]).astype(np.complex64),
        )
        if self.submask and keyed:
            mask_r, mask_p = H.submask_np(mask.astype(np.float32), 0.9,
                                          H.keyed_submask_rng(seed))
            out["mask_r"], out["mask_p"] = mask_r[0], mask_p[0]
        if self.lr_decom:
            out["L_init"], out["R_init"] = decompose_init(
                init_image, self.block_size, self.num_basis,
                overlapping=self.overlapping)
        return out
