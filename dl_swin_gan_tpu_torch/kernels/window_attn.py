"""(Shifted-)window attention: the hand-written CUDA kernels, forward and
backward, and their plain PyTorch versions.

`window_attention(q, k, v, bias, mask)` launches `csrc/window_attn.cu` (the
Hopper port of the Pallas TPU kernel `_pallas_attention` in the JAX
package's `kernels/window_attn.py`: both products on 3xTF32 tensor cores)
for tensors on a CUDA device, and runs `window_attention_plain` for tensors
on the CPU. When q, k, v or the bias require grad, the call goes through a
`torch.autograd.Function` whose backward is `window_attention_bwd`:
`csrc/window_attn_bwd.cu` (the port of `_pallas_attention_bwd`: three
launches on 3xTF32 tensor cores, no atomics) on the GPU,
`window_attention_bwd_plain` on the CPU. `window_attention_fwd` is the
forward kernel with each row's log-sum-exp, which the backward kernel
reads. There is no other route: a CUDA tensor the kernels cannot take
raises. The source notes in the `.cu` files give each kernel's design and
bound.

    q, k, v  [W, H, N, D]   W = batch * windows, H heads, N tokens a window
    bias     [H, N, N]      relative-position bias
    mask     [nW, N, N]     additive shift mask (0 / -100) or None; window w
                            takes row w % nW, and W must be a multiple of nW
    ->       [W, H, N, D]   in q's dtype

The backward gives q, k, v and the bias their gradients (dbias sums over the
windows); the mask gets none, as in the JAX package's custom VJP.
"""

import ctypes
import functools
from typing import Optional

import torch

# gridDim.z holds the window index, gridDim.y the head
_MAX_WINDOWS = 65_535
# the forward kernel indexes a [N, N] bias or mask with int offsets
_MAX_TOKENS = 46_340


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's `_attention_xla` in plain PyTorch: explicit
    products, the bias and mask adds and the softmax in float32, the output
    in v's (= q's) dtype. The CPU path and the tests use it; the CUDA path
    never does."""
    p = _probabilities(q, k, bias, mask)
    return torch.matmul(p.to(v.dtype), v)


def _probabilities(q, k, bias, mask):
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q * scale, k.transpose(-1, -2)).float()
    s = s + bias[None]
    if mask is not None:
        W, nW = q.shape[0], mask.shape[0]
        s = s.reshape(W // nW, nW, *s.shape[1:]) + mask[None, :, None]
        s = s.reshape(W, *s.shape[2:])
    return torch.softmax(s, dim=-1)


def window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor],
                               g: torch.Tensor):
    """The JAX package's `_bwd_kernel` in plain PyTorch, for all windows and
    heads at once: recompute p in float32, then dv = p^T g, dp = g v^T,
    ds = p (dp - rowsum(dp p)), dq = ds k scale, dk = ds^T q scale and
    dbias = the sum of ds over the windows. Returns (dq, dk, dv, dbias) in
    the dtypes of q, k, v and bias. The CPU path and the tests use it; the
    CUDA path never does."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = _probabilities(qf, kf, bias.float(), mask)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            ds.sum(0).to(bias.dtype))


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


def _kernel_inputs(tensors, what):
    """Tensors as the kernels read them: a view with the neg (or conj) bit
    set is resolved to a tensor of its values, since the kernels read raw
    memory; then float32, contiguous and 16-byte aligned, or raise."""
    tensors = [t.resolve_conj().resolve_neg() for t in tensors]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}'s kernel takes float32 only; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}'s kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}'s kernel needs 16-byte aligned inputs")
    return tensors


def _check_kernel_shape(q, what):
    W, H, N, D = q.shape
    if W > _MAX_WINDOWS or H > _MAX_WINDOWS:
        raise ValueError(f"{what}'s kernel takes at most {_MAX_WINDOWS} "
                         f"windows and heads; got W={W}, H={H}")
    if D % 4 or not 4 <= D <= 32:
        raise ValueError(f"{what}'s kernel is not built for head_dim {D} (a "
                         "multiple of 4 up to 32)")


@functools.lru_cache(maxsize=None)
def _library():
    from dl_swin_gan_tpu_torch.kernels import _build

    lib = _build.load("window_attn").cdll
    lib.window_attn_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.window_attn_launch.restype = ctypes.c_int
    lib.window_attn_error_string.argtypes = [ctypes.c_int]
    lib.window_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    from dl_swin_gan_tpu_torch.kernels import _build

    lib = _build.load("window_attn_bwd").cdll
    lib.window_attn_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                       ctypes.c_void_p])
    lib.window_attn_bwd_launch.restype = ctypes.c_int
    lib.window_attn_bwd_error_string.argtypes = [ctypes.c_int]
    lib.window_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def blocks_per_sm(D: int) -> int:
    """Forward-kernel blocks that fit one SM of the current card at head_dim
    D (built on first use)."""
    fn = _library().window_attn_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    n = fn(D)
    if n < 0:
        raise RuntimeError(f"occupancy query failed at head_dim {D}")
    return n


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def window_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         with_lse: bool = True):
    """(out, lse or None): the forward kernel on CUDA tensors, with each
    row's log-sum-exp lse [W, H, N] float32 when `with_lse` (what
    window_attention_bwd's kernel reads)."""
    _check(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention has no kernel for {q.device}")
    tensors = _kernel_inputs([q, k, v, bias]
                             + ([] if mask is None else [mask]),
                             "window_attention")
    q, k, v, bias = tensors[:4]
    mask = tensors[4] if mask is not None else None
    W, H, N, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((W, H, N), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    _check_kernel_shape(q, "window_attention")
    if N > _MAX_TOKENS:
        raise ValueError(f"window_attention's kernel takes at most "
                         f"{_MAX_TOKENS} tokens a window; got {N}")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            _ptr(mask), out.data_ptr(), _ptr(lse),
            W, H, N, D, 1 if mask is None else mask.shape[0], D ** -0.5,
            stream)
    if err != 0:
        raise RuntimeError("window_attention kernel launch failed: "
                           + lib.window_attn_error_string(err).decode())
    window_attention.launches += 1
    return out, lse


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         g: torch.Tensor, out: Optional[torch.Tensor] = None,
                         lse: Optional[torch.Tensor] = None):
    """(dq, dk, dv, dbias) for the cotangent g of window_attention's output:
    the backward kernel on the GPU, which reads the forward's `out` and its
    row log-sum-exp `lse` [W, H, N] (from the forward kernel); the plain
    version on the CPU, which recomputes everything and reads neither."""
    _check(q, k, v, bias, mask)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match q "
                         f"{tuple(q.shape)} on {q.device}")
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, mask, g)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd has no kernel for {q.device}")
    W, H, N, D = q.shape
    if out is None or lse is None or out.shape != q.shape \
            or tuple(lse.shape) != (W, H, N):
        raise ValueError("window_attention_bwd's kernel needs the forward's "
                         "out [W, H, N, D] and lse [W, H, N]")
    tensors = _kernel_inputs([q, k, v, bias, g, out, lse]
                             + ([] if mask is None else [mask]),
                             "window_attention_bwd")
    q, k, v, bias, g, out, lse = tensors[:7]
    mask = tensors[7] if mask is not None else None
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:    # no window: dbias sums nothing
        return dq, dk, dv, torch.zeros_like(bias)
    dbias = torch.empty_like(bias)    # the kernel writes every element
    _check_kernel_shape(q, "window_attention_bwd")
    lib = _bwd_library()
    # each window's ds, written once by the kv pass, read back by the dq
    # pass and summed over the windows in order by the dbias pass
    ds = torch.empty((W, H, N, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            _ptr(mask), g.data_ptr(), out.data_ptr(), lse.data_ptr(),
            ds.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), W, H, N, D,
            1 if mask is None else mask.shape[0], D ** -0.5, stream)
    if err != 0:
        raise RuntimeError("window_attention backward kernel launch failed: "
                           + lib.window_attn_bwd_error_string(err).decode())
    window_attention_bwd.launches += 1
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    """The forward kernel (keeping its row log-sum-exp) and the backward
    kernel on the GPU; the plain versions on the CPU. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        if q.device.type == "cpu":
            out, lse = window_attention_plain(q, k, v, bias, mask), None
        else:
            out, lse = window_attention_fwd(q, k, v, bias, mask, with_lse=True)
        ctx.has_mask = mask is not None
        ctx.save_for_backward(q, k, v, bias, out,
                              *(t for t in (lse, mask) if t is not None))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, *rest = ctx.saved_tensors
        lse = rest.pop(0) if q.device.type != "cpu" else None
        mask = rest[0] if ctx.has_mask else None
        dq, dk, dv, dbias = window_attention_bwd(
            q, k, v, bias, mask, g.contiguous(), out, lse)
        return dq, dk, dv, dbias, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias (+ mask)) v: the CUDA kernel on the GPU,
    the plain version on the CPU; differentiable in q, k, v and bias."""
    _check(q, k, v, bias, mask)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias)):
        return _WindowAttention.apply(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask)
    return window_attention_fwd(q, k, v, bias, mask, with_lse=False)[0]


# kernel launches so far in this process; chip_smoke.py zeroes and reads them
window_attention.launches = 0
window_attention_bwd.launches = 0
