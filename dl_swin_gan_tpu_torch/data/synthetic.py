"""Synthetic dynamic-MRI phantom generator (host-side numpy).

A copy of `data/synthetic.py` in the JAX package, so both packages make the
same slices from the same seed: fully-sampled k-space = F(images x maps) in
the storage convention of the prepared datasets (fftmod'ed k-space, DC at
N/2; centered images; ESPIRiT-normalized maps). `h5py` is imported only by
the writer; `quality_split` makes the quality set's splits in memory.
"""

import os
from typing import Optional, Tuple

import numpy as np

from dl_swin_gan_tpu_torch.data import host_ops as H


def _coil_sensitivities(Y: int, X: int, C: int, rng) -> np.ndarray:
    """Smooth, ESPIRiT-normalized (sum |s|^2 = 1) coil maps [C, Y, X]."""
    yy, xx = np.mgrid[0:Y, 0:X]
    maps = np.zeros((C, Y, X), np.complex64)
    for c in range(C):
        ang = 2 * np.pi * c / C
        cy = Y / 2 + 0.55 * Y * np.sin(ang) * (0.8 + 0.4 * rng.rand())
        cx = X / 2 + 0.55 * X * np.cos(ang) * (0.8 + 0.4 * rng.rand())
        sens = np.exp(-(((yy - cy) / Y) ** 2 + ((xx - cx) / X) ** 2) * 3.0)
        phase = np.exp(1j * (2 * np.pi * rng.rand()
                             + 0.5 * ((yy - cy) / Y + (xx - cx) / X)))
        maps[c] = sens * phase
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0, keepdims=True)) + 1e-8
    return maps


def _cine_frames(T: int, Y: int, X: int, rng) -> np.ndarray:
    """A beating heart-like phantom: pulsing ellipse + static anatomy [T, Y, X]."""
    yy, xx = np.mgrid[0:Y, 0:X]
    body = np.exp(-(((yy - Y / 2) / (0.45 * Y)) ** 2
                    + ((xx - X / 2) / (0.45 * X)) ** 2) * 2.0)
    ring_r = 0.30 * min(Y, X)
    ring = (np.abs(np.sqrt((yy - Y / 2) ** 2 + (xx - X / 2) ** 2) - ring_r) < 2.5)
    cy0, cx0 = Y * (0.45 + 0.1 * rng.rand()), X * (0.45 + 0.1 * rng.rand())
    frames = []
    for t in range(T):
        beat = np.sin(2 * np.pi * t / T)
        r = (0.12 + 0.04 * beat) * min(Y, X)
        lv = (((yy - cy0) ** 2 + (xx - cx0) ** 2) < r ** 2).astype(np.float32)
        wall = (np.abs(np.sqrt((yy - cy0) ** 2 + (xx - cx0) ** 2) - r) < 3)
        frames.append(0.4 * body + 0.3 * ring + lv + 0.6 * wall)
    img = np.stack(frames).astype(np.complex64)
    # smooth background phase (MRI images are complex)
    img = img * np.exp(1j * (0.15 * xx / X + 0.1 * yy / Y))
    return img.astype(np.complex64)


def make_cine_example(T: int = 16, Y: int = 96, X: int = 64, C: int = 8,
                      E: int = 2, seed: int = 0, noise: float = 0.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One slice in reference layout: (kspace [C,T,Y,X], maps [E,C,1,Y,X],
    target [E,T,Y,X]), fftmod storage convention."""
    rng = np.random.RandomState(seed)
    img = _cine_frames(T, Y, X, rng)                   # [T, Y, X]
    smaps = _coil_sensitivities(Y, X, C, rng)          # [C, Y, X]

    coil_ims = smaps[:, None] * img[None]              # [C, T, Y, X]
    k_centered = np.fft.fftshift(
        np.fft.fft2(np.fft.ifftshift(coil_ims, axes=(-2, -1)),
                    axes=(-2, -1), norm="ortho"), axes=(-2, -1))
    kspace = H.fftmod(k_centered).astype(np.complex64)
    if noise > 0:
        kspace = kspace + noise * (rng.standard_normal(kspace.shape)
                                   + 1j * rng.standard_normal(kspace.shape)
                                   ).astype(np.complex64)

    maps = np.zeros((E, C, 1, Y, X), np.complex64)
    maps[0] = smaps[:, None]
    # second emap: tiny orthogonal-ish component (ESPIRiT soft second set)
    if E > 1:
        maps[1] = 0.05 * np.roll(smaps[:, None], Y // 4, axis=-2)

    target = H.sense_adjoint(kspace[None], maps[None])[0].astype(np.complex64)
    return kspace, maps, target


def synthetic_files(num_files: int = 2, slices: int = 2, T: int = 16,
                    Y: int = 96, X: int = 64, C: int = 8, E: int = 2,
                    seed: int = 0, noise: float = 0.0):
    """Yield one (name, kspace [S,C,T,Y,X], maps [S,E,C,1,Y,X],
    target [S,E,T,Y,X]) per file: what `write_synthetic_dataset` writes to
    `<name>.h5`, slice s of file f seeded with seed + 97*f + s."""
    for f in range(num_files):
        ks, mp, tg = [], [], []
        for s in range(slices):
            k, m, t = make_cine_example(T, Y, X, C, E,
                                        seed=seed + 97 * f + s, noise=noise)
            ks.append(k); mp.append(m); tg.append(t)
        yield f"synthetic_{f:03d}", np.stack(ks), np.stack(mp), np.stack(tg)


def write_synthetic_dataset(root: str, num_files: int = 2, slices: int = 2,
                            T: int = 16, Y: int = 96, X: int = 64, C: int = 8,
                            E: int = 2, seed: int = 0, noise: float = 0.0) -> list:
    """Write reference-layout HDF5 files (kspace/maps/target per patient)."""
    import h5py
    os.makedirs(root, exist_ok=True)
    paths = []
    for name, ks, mp, tg in synthetic_files(num_files, slices, T, Y, X, C, E,
                                            seed, noise):
        path = os.path.join(root, f"{name}.h5")
        with h5py.File(path, "w") as h5:
            h5.create_dataset("kspace", data=ks)
            h5.create_dataset("maps", data=mp)
            h5.create_dataset("target", data=tg)
        paths.append(path)
    return paths


# the synthetic quality set of `datasets/make_quality_set.sh`: seed 0; per
# file 4 slices of 18 phases x 156 x 96, 8 coils, 2 maps, k-space noise
# 0.002; per split its file count and seed offset
QUALITY_SET = dict(slices=4, T=18, Y=156, X=96, C=8, E=2, noise=0.002)
QUALITY_SEED = 0
QUALITY_SPLITS = {"train": (8, 0), "validate": (2, 10_000),
                  "test": (6, 20_000)}


def quality_split(split: str, num_files: Optional[int] = None,
                  **cut) -> list:
    """The quality set's `split` ('train', 'validate' or 'test') in memory,
    without h5py: the files `datasets/make_quality_set.sh` writes under
    runs/quality/data/<split>/, as `synthetic_files` records. `num_files`
    keeps the first files only; `cut` overrides the slice geometry
    (slices, T, Y, X, C, E, noise), for tests at a reduced size."""
    files, offset = QUALITY_SPLITS[split]
    geometry = {**QUALITY_SET, **cut}
    return list(synthetic_files(files if num_files is None else num_files,
                                seed=QUALITY_SEED + offset, **geometry))


def as_h5_files(files, directory: str) -> list:
    """`files` (records as `synthetic_files` makes them) renamed to the
    paths `Hdf5Dataset` gives the same files written under `directory`:
    its glob's os.path.join(directory, name + ".h5"). A seeded
    `CinePreprocess` draws its crops, flips and mask from that name, so a
    row held in memory validates on the masks of a run that read the H5
    files from that directory."""
    return [(os.path.join(directory, f"{name}.h5"), k, m, t)
            for name, k, m, t in files]
