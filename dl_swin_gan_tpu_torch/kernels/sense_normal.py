"""SENSE normal operator A^H W^2 A: the hand-written CUDA kernel and its
plain PyTorch version.

`sense_normal(x, maps, w)` launches `csrc/sense_normal.cu` (the Hopper port
of the Pallas TPU kernel `sense_normal_fused` in the JAX package's
`kernels/sense_normal.py`) for tensors on a CUDA device, and runs
`sense_normal_plain` for tensors on the CPU. There is no other route: a CUDA
tensor the kernel cannot take raises. The source note in the `.cu` file
gives the kernel's design and its bound.

    x     [B, E, T, Y, X] complex64      image, E ESPIRiT maps
    maps  [B, E, C, Y, X] complex64      coil maps (set dim squeezed)
    w     [B, T, Y, X]    float32        k-space weight (mask squared)
    ->    [B, E, T, Y, X] complex64
"""

import ctypes
import functools

import numpy as np
import torch

# the largest dynamic shared memory a Hopper block may opt into; the kernel
# keeps the complex64 frame and two chunks of 16 rows there (rows of 2X
# floats rounded up to 32), or of 8, 4, 2 or 1 rows where 16 do not fit
_SMEM_LIMIT = 232_448


@functools.lru_cache(maxsize=None)
def ortho_dft(n: int, device: torch.device) -> torch.Tensor:
    """Symmetric unitary DFT matrix [n, n]: built in float64, rounded to
    complex64 (the same matrices as the TPU kernel's `_ortho_dft`). A normal
    tensor even when first built under torch.inference_mode, so that the
    plain version's autograd can save it."""
    k = np.arange(n, dtype=np.float64)
    m = np.exp(-2j * np.pi * np.outer(k, k) / n) / np.sqrt(n)
    with torch.inference_mode(False):
        return torch.from_numpy(m.astype(np.complex64)).to(device)


def _tf32_split(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` as (hi, lo) pairs stacked on a new last axis: hi = a
    rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
    from zero: the low 13 mantissa bits cleared), lo = a - hi rounded the
    same way; hi + lo holds a to about 2^-22."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = tf32(a)
    return torch.stack([hi, tf32(a - hi)], -1)


@functools.lru_cache(maxsize=None)
def coil_tables(Y: int, X: int, device: torch.device):
    """The DFT tables the coil pass reads, split into TF32 (hi, lo) parts
    for its 3xTF32 products (built once per shape and device, as normal
    tensors):

        fy  [Y, Y, 4]               ortho_dft(Y), each entry as (re hi,
                                    re lo, im hi, im lo)
        fx  [X/8, 2X/8, 8, 4, 2, 2]  ortho_dft(X) as stored, [X, 2X] floats
                                    zero-padded to multiples of 8, each
                                    (hi, lo), in the order of
                                    mma.sync.m16n8k8's B operand: per
                                    k-step, n-tile and lane (4g + t), rows
                                    t and t + 4 of column g of the tile
    """
    with torch.inference_mode(False):
        fy = _tf32_split(torch.view_as_real(ortho_dft(Y, device)))
        fx = torch.view_as_real(ortho_dft(X, device)).reshape(X, 2 * X)
        kp, n2 = -(-X // 8) * 8, -(-2 * X // 8) * 8
        b = torch.zeros((kp, n2), dtype=torch.float32, device=device)
        b[:X, :2 * X] = fx
        frags = b.reshape(kp // 8, 2, 4, n2 // 8, 8).permute(0, 3, 4, 2, 1)
        return (fy.reshape(Y, Y, 4).contiguous(),
                _tf32_split(frags).contiguous())


def sense_normal_plain(x: torch.Tensor, maps: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: coil expansion, DFTs as
    dense products with the same matrices, weight, inverse DFTs, coil
    combine. The CPU path and the tests use it; the CUDA path never does."""
    fy = ortho_dft(x.shape[3], x.device)
    fx = ortho_dft(x.shape[4], x.device)
    coils = (maps.unsqueeze(3) * x.unsqueeze(2)).sum(1)    # [B, C, T, Y, X]
    k = fy @ coils @ fx
    k = k * w.unsqueeze(1)
    coils = fy.conj() @ k @ fx.conj()
    return (maps.conj().unsqueeze(3) * coils.unsqueeze(1)).sum(2)


def normal_work(E: int, C: int, w: torch.Tensor):
    """(DFT FLOP, other FLOP, bytes) of one call as the kernel does it: DFTs
    as dense complex products (8 FLOP per complex multiply-add) over the R
    k-space rows of each frame that hold a nonzero weight: the y-DFT to
    those rows, both x-DFTs on them, the inverse y-DFT from them; then the
    weight, the coil expansion and the coil sum. The DFT tables count as the
    complex64 matrices the function needs, 8 bytes per entry (the kernel's
    hi/lo split of them is its own choice). w is the call's [B, T, Y, X]
    weight."""
    B, T, Y, X = w.shape
    rows = int((w != 0).any(dim=3).sum().item())   # R summed over (b, t)
    yx = Y * X
    dft = C * rows * 8 * X * (2 * Y + 2 * X)        # the four DFT passes
    other = C * (rows * X * 2                       # k-space weight
                 + B * T * 8 * E * yx * 2)          # coil expansion, combine
    nbytes = (8 * B * E * T * yx * 2                # x in, out
              + 8 * B * E * C * yx                  # maps
              + 4 * B * T * yx                      # w
              + 8 * (Y * Y + X * X))                # DFT tables
    return dft, other, nbytes


def _check(x, maps, w):
    if x.ndim != 5 or maps.ndim != 5 or w.ndim != 4:
        raise ValueError("sense_normal expects x [B,E,T,Y,X], maps [B,E,C,Y,X], "
                         f"w [B,T,Y,X]; got {tuple(x.shape)}, "
                         f"{tuple(maps.shape)}, {tuple(w.shape)}")
    B, E, T, Y, X = x.shape
    if maps.shape[:2] != (B, E) or maps.shape[3:] != (Y, X):
        raise ValueError(f"maps {tuple(maps.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if tuple(w.shape) != (B, T, Y, X):
        raise ValueError(f"w {tuple(w.shape)} is not {(B, T, Y, X)}")
    if x.dtype != torch.complex64 or maps.dtype != torch.complex64:
        raise TypeError(f"x and maps must be complex64, got {x.dtype}, "
                        f"{maps.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not (x.device == maps.device == w.device):
        raise ValueError("x, maps and w must be on one device")


def bind(cdll):
    """Declare the C interface of a built sense_normal.cu on `cdll`."""
    cdll.sense_normal_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    cdll.sense_normal_launch.restype = ctypes.c_int
    cdll.sense_normal_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    cdll.sense_normal_smem_bytes.restype = ctypes.c_longlong
    cdll.sense_normal_error_string.argtypes = [ctypes.c_int]
    cdll.sense_normal_error_string.restype = ctypes.c_char_p
    return cdll


@functools.lru_cache(maxsize=None)
def _library():
    from dl_swin_gan_tpu_torch.kernels import _build

    return bind(_build.load("sense_normal").cdll)


def blocks_per_sm(Y: int, X: int, lib=None) -> int:
    """Blocks of the coil-pass kernel that fit one SM of the current card for
    a Y x X frame, in `lib` (a built sense_normal.cu or llr_normal.cu, both
    of which hold it; this module's by default, built on first use)."""
    fn = (lib or _library()).coil_normal_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(Y, X)
    if n < 0:
        raise RuntimeError(f"occupancy query failed for a {Y}x{X} frame")
    return n


def sense_normal(x: torch.Tensor, maps: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """A^H W^2 A x: the CUDA kernel on the GPU, the plain version on the CPU.

    The kernel skips the k-space rows whose weights are all zero, which is
    exact for finite inputs (inf or NaN k-space in such a row is dropped
    instead of spreading through the inverse DFT)."""
    _check(x, maps, w)
    if x.device.type == "cpu":
        return sense_normal_plain(x, maps, w)
    if x.device.type != "cuda":
        raise ValueError(f"sense_normal has no kernel for {x.device}")
    # the kernel reads raw memory: a view with the conj or neg bit set (such
    # as x.conj(), or a cotangent autograd made lazily) is resolved first
    x, maps, w = (t.resolve_conj().resolve_neg() for t in (x, maps, w))
    if not (x.is_contiguous() and maps.is_contiguous() and w.is_contiguous()):
        raise ValueError("sense_normal's kernel needs contiguous inputs")
    if x.numel() == 0 or maps.shape[2] == 0:
        return torch.zeros_like(x)
    out = launch(_library(), x, maps, w, *coil_tables(*x.shape[3:], x.device))
    sense_normal.launches += 1
    return out


def launch(lib, x, maps, w, fy, fx):
    """One launch of a built sense_normal.cu (`lib`, declared by `bind`) on
    checked, contiguous CUDA inputs with the DFT tables it reads
    (`coil_tables`); counts nothing."""
    B, E, T, Y, X = x.shape
    C = maps.shape[2]
    smem = lib.sense_normal_smem_bytes(Y, X)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a {Y}x{X} frame needs {smem} bytes of shared "
                         f"memory; the kernel takes at most {_SMEM_LIMIT}")
    coil = torch.empty((B, T, C, Y, X), dtype=torch.complex64, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sense_normal_launch(
            x.data_ptr(), maps.data_ptr(), w.data_ptr(), fy.data_ptr(),
            fx.data_ptr(), coil.data_ptr(), out.data_ptr(),
            B, E, C, T, Y, X, stream)
    if err != 0:
        raise RuntimeError("sense_normal kernel launch failed: "
                           + lib.sense_normal_error_string(err).decode())
    return out


# kernel launches so far in this process; chip_smoke.py zeroes and reads it
sense_normal.launches = 0
