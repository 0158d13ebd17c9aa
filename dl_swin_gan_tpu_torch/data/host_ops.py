"""Numpy twins of the operator core for the host-side input pipeline.

A copy of `data/host_ops.py` in the JAX package (numpy only, bit-identical
results): the inference transforms and the synthetic phantom run these on the
host before a batch goes to the device. `submask_np` is a copy of the JAX
package's `train/diffusion_trainer.py submask_np`, the DDPM_X mask split.
"""

import numpy as np


def fft2(data: np.ndarray) -> np.ndarray:
    """Ortho-normalized uncentered 2D FFT over the trailing axes."""
    return np.fft.fftn(data, axes=(-2, -1), norm="ortho")


def ifft2(data: np.ndarray) -> np.ndarray:
    return np.fft.ifftn(data, axes=(-2, -1), norm="ortho")


def sense_adjoint(y: np.ndarray, maps: np.ndarray,
                  mask: np.ndarray = None) -> np.ndarray:
    """x = sum_c conj(maps_c) * F^H(W y); y [B,C,T,Y,X], maps [B,E,C,1,Y,X]."""
    if mask is not None:
        y = y * mask
    coil_ims = ifft2(y)
    return np.sum(coil_ims[:, None] * np.conj(maps), axis=2)


def sense_forward(x: np.ndarray, maps: np.ndarray,
                  mask: np.ndarray = None) -> np.ndarray:
    ksp = fft2(np.sum(x[:, :, None] * maps, axis=1))
    if mask is not None:
        ksp = ksp * mask
    return ksp


def get_mask(data: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return (np.abs(data) > eps).astype(np.float32)


def time_average(data: np.ndarray, axis: int, eps: float = 1e-6,
                 keepdims: bool = True) -> np.ndarray:
    mask = get_mask(data)
    return data.sum(axis, keepdims=keepdims) / (mask.sum(axis, keepdims=keepdims) + eps)


def sliding_window(data: np.ndarray, axis: int, window_size: int) -> np.ndarray:
    """Circular sliding-window view sharing (reference utils.py:37-49)."""
    nt = data.shape[axis]
    assert 0 < window_size <= nt
    out = []
    for i in range(nt):
        shifted = np.roll(data, int(window_size / 2) - i, axis=axis)
        window = np.take(shifted, np.arange(window_size), axis=axis)
        out.append(time_average(window, axis))
    return np.concatenate(out, axis=axis)


def fftmod(data: np.ndarray) -> np.ndarray:
    """Checkerboard (-1)^(x+y+1) modulation (reference utils.py:7-19)."""
    ny, nx = data.shape[-2], data.shape[-1]
    iy = np.arange(ny).reshape(ny, 1)
    ix = np.arange(nx).reshape(1, nx)
    return data * np.where((iy + ix + 1) % 2 == 0, 1.0, -1.0)


def center_crop(data: np.ndarray, shapes, axes) -> np.ndarray:
    slicer = [slice(None)] * data.ndim
    for size, ax in zip(shapes, axes):
        start = (data.shape[ax] - size) // 2
        slicer[ax] = slice(start, start + size)
    return data[tuple(slicer)]


def keyed_submask_rng(seed: tuple) -> np.random.RandomState:
    """The stream of the DDPM_X split of an example whose draws are seeded
    from `seed` = (draw_seed, k): a key of its own, so that the split, like
    the example's other draws, is fixed by its global position k, whichever
    rank draws it."""
    return np.random.RandomState(tuple(seed) + (99,))


def submask_np(mask: np.ndarray, factor: float,
               rng: np.random.RandomState):
    """The DDPM_X split of the acquired lines, per frame: `factor` of the
    acquired ky lines (a permutation drawn from `rng`) are removed from
    mask_r, and the others from mask_p. mask [B, 1, F, Y, X]. A bit-exact
    twin of the JAX package's `train/diffusion_trainer.py submask_np`."""
    mask_unsamp = mask.copy()
    mask_inv_unsamp = mask.copy()
    for b in range(mask.shape[0]):
        for f in range(mask.shape[2]):
            ones = np.nonzero(mask[b, 0, f].sum(axis=1))[0]
            num_remove = int(ones.shape[0] * factor)
            perm = rng.permutation(ones.shape[0])
            mask_unsamp[b, 0, f, ones[perm[:num_remove]], :] = 0
            mask_inv_unsamp[b, 0, f, ones[perm[num_remove:]], :] = 0
    return mask_unsamp, mask_inv_unsamp
