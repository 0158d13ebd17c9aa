"""Operations and bytes of one SENSE normal operator A^H W^2 A x.

x [B, E, T, Y, X] and out complex64, maps [B, E, C, Y, X] complex64,
w [B, T, Y, X] float32. Counted as the operator needs them, whatever
implements it:

  - per coil and frame, the forward expands the image over the E maps
    (E complex multiply-adds, 8 FLOP each), transforms the Y columns in
    full (X transforms of length Y) and the rows only where ky is acquired
    (n_acq transforms of length X), and weights the acquired samples (2
    FLOP each); the adjoint mirrors it and combines with the conjugate maps
    (E multiply-adds);
  - a length-N complex FFT is 5 N log2 N FLOP;
  - bytes: x, maps and w read once, out written once. DFT tables and any
    scratch are the implementation's and are not counted.
"""

import math

import numpy as np


def fft_flops(n: int) -> float:
    return 5.0 * n * math.log2(n) if n > 1 else 0.0


def work(E: int, C: int, Y: int, X: int, acquired_rows: np.ndarray):
    """(FLOP, bytes) of one call; acquired_rows [B, T]: the ky rows with a
    nonzero weight in each frame."""
    rows = np.asarray(acquired_rows, dtype=np.float64)
    B, T = rows.shape
    per_frame = (X * fft_flops(Y) + rows * fft_flops(X)     # forward FFT
                 + rows * X * 2                             # weights
                 + rows * fft_flops(X) + X * fft_flops(Y))  # adjoint FFT
    flops = C * per_frame.sum() + B * T * C * Y * X * E * 8 * 2
    nbytes = (2 * B * E * T * Y * X * 8 + B * E * C * Y * X * 8
              + B * T * Y * X * 4)
    return float(flops), float(nbytes)


def acquired(w) -> np.ndarray:
    """[B, T] acquired ky rows of a weight or mask [B, (1,) T, Y, X]."""
    a = np.asarray(w)
    if a.ndim == 5:
        a = a[:, 0]
    return (np.abs(a) > 0).any(-1).sum(-1)
