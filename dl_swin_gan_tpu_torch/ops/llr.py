"""Locally-low-rank (LLR) block operators and the truncated-SVD factors.

Counterpart of `ops/llr.py` in the JAX package (the reference's
`dl_cs/mri/lowrank.py`):

  - `BlockOp`: overlapping block extract/combine with a periodic sqrt-Hann
    window, stride b/2, the padding rule that fits an odd number of blocks
    per axis, and normalisation by the fold weights combine(extract(1)).
  - `decompose` / `compose`: truncated SVD of each block into
    L [N, e*b^2, r] and R [N, t, r] with sqrt(S) split between the factors,
    and the image L R^H folded back.
  - `decompose_init`: the host loader's numpy L0/R0.

Every function takes torch tensors or numpy arrays (`xp=np` builds a numpy
BlockOp). The numpy path runs the same numpy calls in the same order as the
JAX package's, so the loader's L0/R0 are bit-identical in both packages.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _is_np(x) -> bool:
    return isinstance(x, np.ndarray)


def _cat(xs, axis):
    return np.concatenate(xs, axis=axis) if _is_np(xs[0]) else torch.cat(
        xs, dim=axis)


def _pad(x, pads):
    """Zero-pad with numpy's [(lo, hi), ...] per axis."""
    if _is_np(x):
        return np.pad(x, pads)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat)


def _permute(x, axes):
    return x.transpose(axes) if _is_np(x) else x.permute(axes)


def hann_sqrt_1d(block_size: int) -> np.ndarray:
    """The periodic sqrt-Hann window of one axis, in float64:
    w[n] = sqrt(0.5 (1 - cos(2 pi n / b)))."""
    n = np.arange(block_size)
    return (0.5 * (1 - np.cos(2 * np.pi * n / block_size))) ** 0.5


def _hann_sqrt_window(block_size: int, ne: int, xp, device):
    """The 2D window flattened like the blocks' (e, i, j) axis: [1, e*b^2, 1]."""
    win1d = hann_sqrt_1d(block_size)
    win = win1d[:, None] * win1d[None, :]
    win = np.tile(win[None], (ne, 1, 1)).reshape(1, ne * block_size ** 2, 1)
    win = win.astype(np.float32)
    return win if xp is np else torch.from_numpy(win).to(device)


class BlockOp:
    """Array <-> overlapping blocks linear operator.

    extract():  [1, e, t, y, x] -> [N, e*b^2, t]
    combine():  [N, e*b^2, t]   -> [1, e, t, y, x]
    Called like the reference module: op(x) extracts, op(b, adjoint=True)
    combines. `xp` is `torch` (tensors on `device`) or `numpy`.
    """

    def __init__(self, block_size: int, image_shape, overlapping: bool = True,
                 xp=torch, device=None):
        if overlapping is not True:
            raise ValueError("the reference supports only overlapping blocks")
        self.block_size = b = block_size
        self.stride = s = block_size // 2
        _, self.ne, self.nt, self.ny, self.nx = image_shape
        self.win = _hann_sqrt_window(b, self.ne, xp, device)

        # pad so that an odd number of blocks fits per axis
        nbx_coarse = self.nx // b + 1
        nby_coarse = self.ny // b + 1
        pxl = (b * nbx_coarse - self.nx) // 2
        pxr = pxl if self.nx % 2 == 0 else pxl + 1
        pyl = (b * nby_coarse - self.ny) // 2
        pyr = pyl if self.ny % 2 == 0 else pyl + 1
        self.pad_x, self.pad_y = (pxl, pxr), (pyl, pyr)
        self.nx_pad = pxl + self.nx + pxr
        self.ny_pad = pyl + self.ny + pyr
        self.num_blocks_x = (self.nx_pad - b) // s + 1
        self.num_blocks_y = (self.ny_pad - b) // s + 1
        self.num_blocks = self.num_blocks_x * self.num_blocks_y

        # normalisation weights: combine(extract(ones))
        self.weights = None
        shape = tuple(image_shape)
        ones = (np.ones(shape, dtype=np.complex64) if xp is np else
                torch.ones(shape, dtype=torch.complex64, device=device))
        self.weights = self.combine(self.extract(ones))

    # -- unfold ---------------------------------------------------------------
    def _unfold(self, images):
        """[1, e, t, ny_pad, nx_pad] -> [N, e*b^2, t], blocks in (by, bx)
        row-major order. Stride b/2: each block is a pair of adjacent
        stride tiles per axis, so each axis is two slices and a concat."""
        b, s = self.block_size, self.stride
        x = images[0]  # [e, t, Ypad, Xpad]
        e, t, yp, xpad = x.shape
        v = x.reshape(e, t, yp // s, s, xpad)
        y_pairs = _cat([v[:, :, :-1], v[:, :, 1:]], axis=3)
        w = y_pairs.reshape(e, t, self.num_blocks_y, b, xpad // s, s)
        x_pairs = _cat([w[..., :-1, :], w[..., 1:, :]], axis=-1)
        # [e, t, nby, by, nbx, bx] -> (nby, nbx, e, by, bx, t) -> [N, e*b*b, t]
        out = _permute(x_pairs, (2, 4, 0, 3, 5, 1))
        return out.reshape(self.num_blocks, self.ne * b * b, self.nt)

    def _fold(self, blocks):
        """Overlap-add inverse of _unfold: per axis, the blocks' first and
        second halves abut without overlap, so each axis is two reshapes,
        two shifted pads and one add."""
        b, s = self.block_size, self.stride
        nby, nbx = self.num_blocks_y, self.num_blocks_x
        e, t = self.ne, self.nt
        blk = blocks.reshape(nby, nbx, e, b, b, t)
        blk = _permute(blk, (2, 5, 0, 3, 1, 4))  # [e, t, nby, by, nbx, bx]

        # x axis: [e, t, nby, by, nbx, bx] -> [e, t, nby, by, nx_pad]
        x1 = blk[..., :s].reshape(e, t, nby, b, nbx * s)
        x2 = blk[..., s:].reshape(e, t, nby, b, nbx * s)
        pad4 = [(0, 0)] * 4
        x = _pad(x1, pad4 + [(0, s)]) + _pad(x2, pad4 + [(s, 0)])

        # y axis: [e, t, nby, by, X] -> [e, t, ny_pad, X]
        y1 = x[..., :s, :].reshape(e, t, nby * s, self.nx_pad)
        y2 = x[..., s:, :].reshape(e, t, nby * s, self.nx_pad)
        pad2 = [(0, 0)] * 2
        out = (_pad(y1, pad2 + [(0, s), (0, 0)])
               + _pad(y2, pad2 + [(s, 0), (0, 0)]))
        return out[None]

    # -- public ------------------------------------------------------------------
    def extract(self, data):
        pads = [(0, 0)] * 3 + [self.pad_y, self.pad_x]
        return self._unfold(_pad(data, pads)) * self.win

    def combine(self, data):
        images = self._fold(data * self.win)
        # center crop the padding away
        ys = (self.ny_pad - self.ny) // 2
        xs = (self.nx_pad - self.nx) // 2
        images = images[..., ys:ys + self.ny, xs:xs + self.nx]
        if self.weights is not None:
            images = images / (self.weights + 1e-8)
        return images

    def __call__(self, data, adjoint: bool = False):
        return self.combine(data) if adjoint else self.extract(data)


def btranspose(m):
    """Hermitian transpose of a batch of matrices [N, a, b] -> [N, b, a]."""
    if _is_np(m):
        return m.conj().transpose(0, 2, 1)
    return m.conj().transpose(-2, -1)


def decompose(blocks, rank: int) -> Tuple:
    """Truncated SVD of [N, e*b^2, t] blocks -> (L [N, e*b^2, r],
    R [N, t, r]) with sqrt(S) split between the factors."""
    if _is_np(blocks):
        U, S, Vh = np.linalg.svd(blocks, full_matrices=False)
        s_sqrt = np.sqrt(S[:, :rank])[:, None, :]
    else:
        U, S, Vh = torch.linalg.svd(blocks, full_matrices=False)
        s_sqrt = torch.sqrt(S[:, :rank])[:, None, :]
    V = btranspose(Vh)
    return U[:, :, :rank] * s_sqrt, V[:, :, :rank] * s_sqrt


def compose(L, R, block_op: BlockOp):
    """L R^H -> blocks -> image."""
    return block_op(L @ btranspose(R), adjoint=True)


def decompose_init(init_image: np.ndarray, block_size: int, rank: int,
                   overlapping: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy) L0/R0 for the loader, from the init image
    [1, e, t, y, x]."""
    img = np.asarray(init_image)
    op = BlockOp(block_size, img.shape, overlapping, xp=np)
    L, R = decompose(op.extract(img), rank)
    return L.astype(np.complex64), R.astype(np.complex64)
