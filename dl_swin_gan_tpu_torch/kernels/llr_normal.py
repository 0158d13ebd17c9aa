"""Block-LLR normal operator for the DSLR CG chain: the hand-written CUDA
kernel, its plain PyTorch version and its autograd rule.

Every CG iteration of the DSLR solver applies

    M(blocks) = block_op(A.normal(block_op(blocks, adjoint=True)))

to blocks [N, e*b^2, t] (A = SenseOp(maps, mask)). `llr_normal` launches
`csrc/llr_normal.cu` (the Hopper port of the Pallas TPU kernel
`_llr_normal_pallas` in the JAX package's `kernels/llr_normal.py`) for
tensors on a CUDA device and runs `llr_normal_plain` for tensors on the
CPU. There is no other route: a CUDA tensor the kernel cannot take raises.

With P_y [nby*b, Y] and P_x [nbx*b, X] the windowed block selections and
Dinv the inverse fold weights (`projection_matrices`),

    'pre'  (primal):   M(B)   = P_y A^H W^2 A (Dinv o P_y^T B P_x) P_x^T
    'post' (adjoint):  M^H(B) = P_y (Dinv o A^H W^2 A (P_y^T B P_x)) P_x^T

PyTorch hands a complex autograd Function the conjugate-Wirtinger
cotangent g and wants M^H g back, so the backward is 'post' applied to g
itself (the JAX rule conj(post(conj g)) is the same map under JAX's
convention). The source note in the `.cu` file gives the kernel's design
and its bound.
"""

import ctypes
import functools

import numpy as np
import torch

from dl_swin_gan_tpu_torch.kernels.sense_normal import coil_tables, ortho_dft
from dl_swin_gan_tpu_torch.ops.llr import BlockOp, hann_sqrt_1d

# the largest dynamic shared memory a Hopper block may opt into
_SMEM_LIMIT = 232_448
_SIDES = ("pre", "post")


# ---------------------------------------------------------------------------
# Geometry of one BlockOp
# ---------------------------------------------------------------------------

def projection_matrices(block_op: BlockOp):
    """(P_y [nby*b, Y], P_x [nbx*b, X], dinv [Y, X]) as float32 numpy.

    Row blk*b + i of P selects the padded pixel blk*s + i, scaled by the
    window at i; the pad columns are dropped, so P maps to the cropped image
    grid. The fold normalisation combine(extract(ones)) is separable: per
    axis it is the column sum of P squared."""
    b, s = block_op.block_size, block_op.stride
    w1d = hann_sqrt_1d(b)

    def axis_mat(num_blocks, pad_lo, size):
        m = np.zeros((num_blocks * b, size), np.float32)
        for blk in range(num_blocks):
            for i in range(b):
                col = blk * s + i - pad_lo
                if 0 <= col < size:
                    m[blk * b + i, col] = w1d[i]
        return m

    py = axis_mat(block_op.num_blocks_y, block_op.pad_y[0], block_op.ny)
    px = axis_mat(block_op.num_blocks_x, block_op.pad_x[0], block_op.nx)
    w = (py ** 2).sum(0)[:, None] * (px ** 2).sum(0)[None, :]
    dinv = (1.0 / (w + 1e-8)).astype(np.float32)
    return py, px, dinv


@functools.lru_cache(maxsize=None)
def _constants(block_size: int, image_shape: tuple, device: torch.device):
    """(py, px, dinv, win) of a BlockOp geometry on `device`; normal tensors
    even when first built under torch.inference_mode."""
    op = BlockOp(block_size, image_shape, xp=np)
    py, px, dinv = projection_matrices(op)
    win = hann_sqrt_1d(block_size).astype(np.float32)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (py, px, dinv, win))


def geometry(block_op: BlockOp, device) -> tuple:
    """(py, px, dinv, win) tensors of `block_op` on `device`, cached."""
    shape = (1, block_op.ne, block_op.nt, block_op.ny, block_op.nx)
    return _constants(block_op.block_size, shape, torch.device(device))


def blocks_to_mats(blocks: torch.Tensor, block_op: BlockOp) -> torch.Tensor:
    """[..., N, e*b*b, T] -> [..., T, E, nby*b, nbx*b]: N is (by, bx)
    row-major and e*b*b is (e, i, j) e-major."""
    b = block_op.block_size
    nby, nbx, e = block_op.num_blocks_y, block_op.num_blocks_x, block_op.ne
    lead, t = blocks.shape[:-3], blocks.shape[-1]
    k = len(lead)
    v = blocks.reshape(*lead, nby, nbx, e, b, b, t)
    v = v.permute(*range(k), k + 5, k + 2, k, k + 3, k + 1, k + 4)
    return v.reshape(*lead, t, e, nby * b, nbx * b)


def mats_to_blocks(mats: torch.Tensor, block_op: BlockOp) -> torch.Tensor:
    """Inverse of blocks_to_mats."""
    b = block_op.block_size
    nby, nbx, e = block_op.num_blocks_y, block_op.num_blocks_x, block_op.ne
    lead, t = mats.shape[:-4], mats.shape[-4]
    k = len(lead)
    v = mats.reshape(*lead, t, e, nby, b, nbx, b)
    v = v.permute(*range(k), k + 2, k + 4, k + 1, k + 3, k + 5, k)
    return v.reshape(*lead, block_op.num_blocks, e * b * b, t)


# ---------------------------------------------------------------------------
# Plain version: the matrix form, DFTs as dense products
# ---------------------------------------------------------------------------

def llr_normal_plain(blk, maps, w2, py, px, dinv, d_side: str = "pre"):
    """blk [S, T, E, YB, XB] complex -> the same shape.

    maps [E, C, Y, X] complex, w2 [T, Y, X] real (the mask squared: the
    forward and the adjoint each apply it once), py [YB, Y], px [XB, X],
    dinv [Y, X]. The kernel's arithmetic in plain PyTorch; the CPU path and
    the tests use it, the CUDA path never does."""
    if d_side not in _SIDES:
        raise ValueError(f"d_side must be 'pre' or 'post', got {d_side!r}")
    pyc, pxc = py.to(blk.dtype), px.to(blk.dtype)
    img = pyc.T @ blk @ pxc                                   # [S,T,E,Y,X]
    if d_side == "pre":
        img = img * dinv
    coil = (img.unsqueeze(3) * maps).sum(2)                   # [S,T,C,Y,X]
    fy = ortho_dft(py.shape[1], blk.device)
    fx = ortho_dft(px.shape[1], blk.device)
    k = fy @ coil @ fx
    k = k * w2.unsqueeze(1)
    coil = fy.conj() @ k @ fx.conj()
    out = (coil.unsqueeze(2) * maps.conj()).sum(3)            # [S,T,E,Y,X]
    if d_side == "post":
        out = out * dinv
    return pyc @ out @ pxc.T


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

def _check(blocks, maps, w2, block_op, d_side):
    if d_side not in _SIDES:
        raise ValueError(f"d_side must be 'pre' or 'post', got {d_side!r}")
    b, e, t = block_op.block_size, block_op.ne, block_op.nt
    y, x = block_op.ny, block_op.nx
    if blocks.ndim != 4 or tuple(blocks.shape[1:]) != (
            block_op.num_blocks, e * b * b, t):
        raise ValueError(f"blocks {tuple(blocks.shape)} is not [S, "
                         f"{block_op.num_blocks}, {e * b * b}, {t}]")
    if maps.ndim != 4 or maps.shape[0] != e or tuple(maps.shape[2:]) != (y, x):
        raise ValueError(f"maps {tuple(maps.shape)} is not [{e}, C, {y}, {x}]"
                         " (one set of maps)")
    if tuple(w2.shape) != (t, y, x):
        raise ValueError(f"w2 {tuple(w2.shape)} is not [{t}, {y}, {x}] (one "
                         "mask shared by the coils)")
    if blocks.dtype != torch.complex64 or maps.dtype != torch.complex64:
        raise TypeError(f"blocks and maps must be complex64, got "
                        f"{blocks.dtype}, {maps.dtype}")
    if w2.dtype != torch.float32:
        raise TypeError(f"w2 must be float32, got {w2.dtype}")
    if not (blocks.device == maps.device == w2.device):
        raise ValueError("blocks, maps and w2 must be on one device")


def bind(cdll):
    """Declare the C interface of a built llr_normal.cu on `cdll`."""
    cdll.llr_normal_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    cdll.llr_normal_launch.restype = ctypes.c_int
    cdll.llr_normal_smem_bytes.argtypes = [ctypes.c_int] * 4
    cdll.llr_normal_smem_bytes.restype = ctypes.c_longlong
    cdll.llr_normal_error_string.argtypes = [ctypes.c_int]
    cdll.llr_normal_error_string.restype = ctypes.c_char_p
    return cdll


@functools.lru_cache(maxsize=None)
def _library():
    from dl_swin_gan_tpu_torch.kernels import _build

    return bind(_build.load("llr_normal").cdll)


def llr_normal(blocks: torch.Tensor, maps: torch.Tensor, w2: torch.Tensor,
               block_op: BlockOp, d_side: str = "pre") -> torch.Tensor:
    """M (d_side 'pre') or M^H ('post') of S systems' blocks
    [S, N, e*b^2, T]: the CUDA kernel on the GPU (all S in one launch), the
    plain version on the CPU. maps [E, C, Y, X] complex64, w2 [T, Y, X]
    float32 (the mask squared), shared by the S systems.

    The kernel skips the k-space rows whose weights are all zero, which is
    exact for finite inputs."""
    _check(blocks, maps, w2, block_op, d_side)
    py, px, dinv, win = geometry(block_op, blocks.device)
    if blocks.device.type == "cpu":
        mats = blocks_to_mats(blocks, block_op)
        return mats_to_blocks(
            llr_normal_plain(mats, maps, w2, py, px, dinv, d_side), block_op)
    if blocks.device.type != "cuda":
        raise ValueError(f"llr_normal has no kernel for {blocks.device}")
    # the kernel reads raw memory: a view with the conj or neg bit set is
    # resolved first
    blocks, maps, w2 = (v.resolve_conj().resolve_neg()
                        for v in (blocks, maps, w2))
    if not (blocks.is_contiguous() and maps.is_contiguous()
            and w2.is_contiguous()):
        raise ValueError("llr_normal's kernel needs contiguous inputs")
    if block_op.block_size % 2:
        raise ValueError(f"block size {block_op.block_size} is odd; the "
                         "kernel takes stride b/2")
    if blocks.numel() == 0:
        return torch.zeros_like(blocks)
    out = launch(_library(), blocks, maps, w2, block_op, d_side,
                 *coil_tables(block_op.ny, block_op.nx, blocks.device))
    llr_normal.launches[d_side] += 1
    llr_normal.systems[d_side] += blocks.shape[0]
    return out


def launch(lib, blocks, maps, w2, block_op, d_side, fy, fx):
    """One launch of a built llr_normal.cu (`lib`, declared by `bind`) on
    checked, contiguous CUDA inputs with the DFT tables it reads
    (`sense_normal.coil_tables`); counts nothing."""
    py, px, dinv, win = geometry(block_op, blocks.device)
    S = blocks.shape[0]
    E, C, Y, X = maps.shape
    T, b = block_op.nt, block_op.block_size
    smem = lib.llr_normal_smem_bytes(T, Y, X, b)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"T={T}, {Y}x{X}, b={b} needs {smem} bytes of shared "
                         f"memory; the kernel takes at most {_SMEM_LIMIT}")
    maps_s = maps.unsqueeze(0).expand(S, E, C, Y, X).contiguous()
    w2_s = w2.unsqueeze(0).expand(S, T, Y, X).contiguous()
    img = torch.empty((S, E, T, Y, X), dtype=torch.complex64,
                      device=blocks.device)
    coil = torch.empty((S, T, C, Y, X), dtype=torch.complex64,
                       device=blocks.device)
    img_out = torch.empty_like(img)
    out = torch.empty_like(blocks)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = lib.llr_normal_launch(
            blocks.data_ptr(), maps_s.data_ptr(), w2_s.data_ptr(),
            fy.data_ptr(), fx.data_ptr(), win.data_ptr(), dinv.data_ptr(),
            img.data_ptr(), coil.data_ptr(), img_out.data_ptr(),
            out.data_ptr(), S, E, C, T, Y, X, b, block_op.num_blocks_y,
            block_op.num_blocks_x, block_op.pad_y[0], block_op.pad_x[0],
            int(d_side == "pre"), stream)
    if err != 0:
        raise RuntimeError("llr_normal kernel launch failed: "
                           + lib.llr_normal_error_string(err).decode())
    return out


# kernel launches so far in this process, by variant, and the systems they
# covered (a jacobi launch covers 2); chip_smoke.py zeroes and reads them
llr_normal.launches = dict.fromkeys(_SIDES, 0)
llr_normal.systems = dict.fromkeys(_SIDES, 0)


class _LLRNormal(torch.autograd.Function):
    """Forward 'pre'; backward 'post' on the cotangent (M^H g). maps, w2
    and the geometry get no gradient."""

    @staticmethod
    def forward(ctx, blocks, maps, w2, block_op):
        ctx.maps, ctx.w2, ctx.block_op = maps, w2, block_op
        return llr_normal(blocks, maps, w2, block_op, "pre")

    @staticmethod
    def backward(ctx, g):
        return (llr_normal(g.contiguous(), ctx.maps, ctx.w2, ctx.block_op,
                           "post"), None, None, None)


def llr_normal_fused(blocks: torch.Tensor, maps: torch.Tensor,
                     w2: torch.Tensor, block_op: BlockOp) -> torch.Tensor:
    """M(blocks) for blocks [S, N, e*b^2, T], differentiable in blocks."""
    return _LLRNormal.apply(blocks, maps, w2, block_op)


# ---------------------------------------------------------------------------
# Solver-facing wiring
# ---------------------------------------------------------------------------

def fusable(maps, mask) -> bool:
    """The kernel covers the solver's operating point: one system (B=1; the
    DSLR trainer loops beyond that), one set of maps, and a mask shared by
    the coils (or none)."""
    if maps.ndim != 6 or maps.shape[0] != 1 or maps.shape[3] != 1:
        return False
    if mask is not None and (mask.ndim != 5 or mask.shape[0] != 1
                             or mask.shape[1] != 1):
        return False
    return True


def make_fused_block_normal(block_op: BlockOp, maps: torch.Tensor, mask):
    """f(blocks [N, e*b^2, t] [, blocks2]) computing
    block_op(A.normal(block_op(blocks, adjoint=True))) with
    A = SenseOp(maps, mask), through `llr_normal_fused`. Given a second
    blocks argument, both systems run in one launch (S=2), the batched
    operator of the jacobi paired CG. Raises for maps or a mask the kernel
    cannot take."""
    if not fusable(maps, mask):
        raise ValueError(
            "the block-LLR normal operator takes maps [1, E, C, 1, Y, X] and "
            f"a mask [1, 1, T, Y, X] or None; got maps {tuple(maps.shape)}, "
            f"mask {None if mask is None else tuple(mask.shape)}")
    t, y, x = block_op.nt, block_op.ny, block_op.nx
    m = maps[0, :, :, 0].contiguous()                      # [E, C, Y, X]
    if mask is None:
        w2 = torch.ones((t, y, x), dtype=torch.float32, device=maps.device)
    else:
        w = mask[0, 0].to(torch.float32).expand(t, y, x)
        w2 = (w * w).contiguous()

    def f(blocks, blocks2=None):
        if blocks2 is None:
            return llr_normal_fused(blocks.unsqueeze(0), m, w2, block_op)[0]
        out = llr_normal_fused(torch.stack([blocks, blocks2]), m, w2,
                               block_op)
        return out[0], out[1]

    return f
