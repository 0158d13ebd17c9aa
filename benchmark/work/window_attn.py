"""Operations and bytes of one window-attention call over q, k, v
[W, H, N, D] with a bias [H, N, N] and an optional shift mask [nW, N, N]
(0 where a query may see a key, -100 where not), float32 or bfloat16 I/O.

  - forward: the two products q k^T and p v over the (query, key) pairs
    the mask leaves, 2 D FLOP per pair each;
  - backward: its four products (dv, dp, dq, dk), 2 D FLOP per pair each;
  - bytes: q, k, v (and the upstream gradient) read once, out (dq, dk, dv
    and the bias gradient) written once; the bias and the shift mask count
    once, not once per (window, head); softmax statistics and scratch are
    the implementation's.
"""

import numpy as np


def allowed_pairs(W: int, N: int, mask) -> float:
    """(query, key) pairs the mask leaves over all W windows."""
    if mask is None:
        return float(W * N * N)
    m = np.asarray(mask)
    per_window = (m == 0).sum(axis=(1, 2))          # [nW]
    return float(per_window.sum() * (W // m.shape[0]))


def forward(W, H, N, D, mask, io_bytes: int = 4):
    pairs = allowed_pairs(W, N, mask) * H
    flops = 2 * 2 * D * pairs
    nbytes = 4 * W * H * N * D * io_bytes + H * N * N * 4
    if mask is not None:
        nbytes += np.asarray(mask).size * 4
    return float(flops), float(nbytes)


def backward(W, H, N, D, mask, io_bytes: int = 4):
    pairs = allowed_pairs(W, N, mask) * H
    flops = 4 * 2 * D * pairs
    nbytes = 7 * W * H * N * D * io_bytes + 2 * H * N * N * 4
    if mask is not None:
        nbytes += np.asarray(mask).size * 4
    return float(flops), float(nbytes)
