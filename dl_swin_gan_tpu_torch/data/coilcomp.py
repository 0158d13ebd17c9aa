"""Geometric coil compression (GCC).

A copy of `data/coilcomp.py` in the JAX package (the reference's
`datasets/cine/utils/coilcomp.py:16-106`; Zhang et al., "Coil compression
for accelerated imaging with Cartesian sampling", MRM 2013): per-readout-
position SVD of the calibration data with rotation alignment between
neighboring virtual coil bases. Pure numpy, run in the offline
dataset-preparation stage; bit for bit the JAX package's.
"""

import numpy as np


def gcc_matrices(calib: np.ndarray, num_virtual: int,
                 align: bool = True) -> np.ndarray:
    """Compute GCC compression matrices.

    calib: calibration k-space [nx, ny, nc] already IFFT'd along readout
           (hybrid x-ky space).
    Returns mats [nx, nc, num_virtual].
    """
    nx, ny, nc = calib.shape
    mats = np.zeros((nx, nc, num_virtual), np.complex64)
    for x in range(nx):
        block = calib[x].reshape(ny, nc)
        _, _, Vh = np.linalg.svd(block, full_matrices=False)
        mats[x] = Vh.conj().T[:, :num_virtual]

    if align:
        # rotation alignment: make neighboring bases maximally consistent
        for x in range(1, nx):
            prev, cur = mats[x - 1], mats[x]
            C = prev.conj().T @ cur
            U, _, Vh = np.linalg.svd(C, full_matrices=False)
            mats[x] = cur @ (U @ Vh).conj().T
    return mats


def apply_gcc(kspace: np.ndarray, mats: np.ndarray) -> np.ndarray:
    """Compress multicoil k-space [nc, nt, ny, nx(readout)] with per-x mats.

    kspace is transformed to hybrid space along readout, projected onto the
    virtual-coil bases at each readout position, and transformed back.
    """
    hybrid = np.fft.ifft(np.fft.ifftshift(kspace, axes=-1), axis=-1,
                         norm="ortho")
    hybrid = np.fft.fftshift(hybrid, axes=-1)
    nc, nt, ny, nx = hybrid.shape
    nv = mats.shape[-1]
    out = np.zeros((nv, nt, ny, nx), np.complex64)
    for x in range(nx):
        sl = hybrid[..., x].reshape(nc, -1)          # [nc, nt*ny]
        out[..., x] = (mats[x].conj().T @ sl).reshape(nv, nt, ny)
    back = np.fft.ifftshift(out, axes=-1)
    back = np.fft.fft(back, axis=-1, norm="ortho")
    return np.fft.fftshift(back, axes=-1).astype(np.complex64)


def compress(kspace: np.ndarray, num_virtual: int = 8) -> np.ndarray:
    """One-call GCC: estimate matrices from the time-averaged center and
    compress. kspace [coils, (t,) ny, nx]."""
    ksp = kspace if kspace.ndim == 4 else kspace[:, None]
    avg = ksp.mean(axis=1)  # [nc, ny, nx]
    hybrid = np.fft.fftshift(
        np.fft.ifft(np.fft.ifftshift(avg, axes=-1), axis=-1, norm="ortho"),
        axes=-1)
    calib = np.transpose(hybrid, (2, 1, 0))  # [nx, ny, nc]
    mats = gcc_matrices(calib, num_virtual)
    out = apply_gcc(ksp, mats)
    return out if kspace.ndim == 4 else out[:, 0]
