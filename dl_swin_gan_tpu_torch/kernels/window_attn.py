"""(Shifted-)window attention: the hand-written CUDA kernel and its plain
PyTorch version.

`window_attention(q, k, v, bias, mask)` launches `csrc/window_attn.cu` (the
Hopper port of the Pallas TPU kernel `_pallas_attention` in the JAX
package's `kernels/window_attn.py`) for tensors on a CUDA device, and runs
`window_attention_plain` for tensors on the CPU. There is no other route: a
CUDA tensor the kernel cannot take raises. The source note in the `.cu` file
gives the kernel's design and its bound. The forward only: the backward
kernel comes with the Swin training slice.

    q, k, v  [W, H, N, D]   W = batch * windows, H heads, N tokens a window
    bias     [H, N, N]      relative-position bias
    mask     [nW, N, N]     additive shift mask (0 / -100) or None; window w
                            takes row w % nW, and W must be a multiple of nW
    ->       [W, H, N, D]   in q's dtype
"""

import ctypes
import functools
from typing import Optional

import torch

# the largest dynamic shared memory a Hopper block may opt into; the kernel
# keeps K and V of one (window, head) there
_SMEM_LIMIT = 232_448
# gridDim.z holds the window index
_MAX_WINDOWS = 65_535


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's `_attention_xla` in plain PyTorch: explicit
    products, the bias and mask adds and the softmax in float32, the output
    in v's (= q's) dtype. The CPU path and the tests use it; the CUDA path
    never does."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q * scale, k.transpose(-1, -2)).float()
    s = s + bias[None]
    if mask is not None:
        W, nW = q.shape[0], mask.shape[0]
        s = s.reshape(W // nW, nW, *s.shape[1:]) + mask[None, :, None]
        s = s.reshape(W, *s.shape[2:])
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _check(q, k, v, bias, mask):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("window_attention expects q, k, v [W, H, N, D] of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    W, H, N, _ = q.shape
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"bias {tuple(bias.shape)} is not {(H, N, N)}")
    tensors = [q, k, v, bias]
    if mask is not None:
        if mask.ndim != 3 or tuple(mask.shape[1:]) != (N, N):
            raise ValueError(f"mask {tuple(mask.shape)} is not [nW, {N}, {N}]")
        if mask.shape[0] == 0 or W % mask.shape[0]:
            raise ValueError(f"{W} windows are not a multiple of the mask's "
                             f"{mask.shape[0]}")
        tensors.append(mask)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v, bias and mask must be on one device")
    return tensors


@functools.lru_cache(maxsize=None)
def _library():
    from dl_swin_gan_tpu_torch.kernels import _build

    lib = _build.load("window_attn").cdll
    lib.window_attn_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.window_attn_launch.restype = ctypes.c_int
    lib.window_attn_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.window_attn_smem_bytes.restype = ctypes.c_longlong
    lib.window_attn_error_string.argtypes = [ctypes.c_int]
    lib.window_attn_error_string.restype = ctypes.c_char_p
    return lib


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias (+ mask)) v: the CUDA kernel on the GPU,
    the plain version on the CPU."""
    tensors = _check(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention has no kernel for {q.device}")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "window_attention on CUDA has no backward kernel yet: ROADMAP.md "
            "Queue 2 item 2 (ported with the Swin training slice)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("window_attention's kernel takes float32 only; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("window_attention's kernel needs contiguous inputs")
    W, H, N, D = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if W > _MAX_WINDOWS or H > _MAX_WINDOWS:
        raise ValueError(f"window_attention's kernel takes at most "
                         f"{_MAX_WINDOWS} windows and heads; got W={W}, H={H}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("window_attention's kernel needs 16-byte aligned "
                         "inputs")
    if D % 4 or not 4 <= D <= 32:
        raise ValueError(f"window_attention's kernel is not built for "
                         f"head_dim {D} (a multiple of 4 up to 32)")
    lib = _library()
    smem = lib.window_attn_smem_bytes(N, D)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a window of {N} tokens at head_dim {D} needs {smem} "
                         f"bytes of shared memory; the kernel takes at most "
                         f"{_SMEM_LIMIT}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            W, H, N, D, 1 if mask is None else mask.shape[0], D ** -0.5,
            stream)
    if err != 0:
        raise RuntimeError("window_attention kernel launch failed: "
                           + lib.window_attn_error_string(err).decode())
    window_attention.launches += 1
    return out


# kernel launches so far in this process; chip_smoke.py zeroes and reads it
window_attention.launches = 0
