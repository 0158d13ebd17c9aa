"""(Shifted-)window attention: the hand-written CUDA kernels, forward and
backward, and their plain PyTorch versions.

`window_attention(q, k, v, bias, mask)` launches `csrc/window_attn.cu` (the
Hopper port of the Pallas TPU kernel `_pallas_attention` in the JAX
package's `kernels/window_attn.py`: for float32 both products on 3xTF32
tensor cores, for bfloat16 exact bf16 products) for tensors on a CUDA
device, and runs `window_attention_plain` for tensors on the CPU. When q,
k, v or the bias require grad, the call goes through a
`torch.autograd.Function` whose backward is `window_attention_bwd`:
`csrc/window_attn_bwd.cu` (the port of `_pallas_attention_bwd`: for float32
three launches on 3xTF32 tensor cores through a [W, H, N, N] scratch of ds;
for bfloat16 four launches on bf16 tensor cores that recompute ds and keep
no such scratch; no atomics either way, so two calls give bitwise-equal
gradients) on the GPU,
`window_attention_bwd_plain` on the CPU. `window_attention_fwd` is the
forward kernel with each row's log-sum-exp, which the backward kernel
reads. There is no other route: a CUDA tensor the kernels cannot take
raises. The source notes in the `.cu` files give each kernel's design and
bound.

    q, k, v  [W, H, N, D]   W = batch * windows, H heads, N tokens a window;
                            float32 or bfloat16, one dtype
    bias     [H, N, N]      relative-position bias, float32
    mask     [nW, N, N]     additive shift mask (0 / -100) or None, float32;
                            window w takes row w % nW, and W must be a
                            multiple of nW
    ->       [W, H, N, D]   in q's dtype

The backward gives q, k, v and the bias their gradients (dbias sums over the
windows); the mask gets none, as in the JAX package's custom VJP.

The dtype contract is the Pallas kernels' (`_fwd_kernel`, `_bwd_kernel`):
bfloat16 q, k, v (and g) are widened to float32, every product, the
softmax and every sum run in float32, and only the outputs are rounded:
out, dq, dk and dv to their inputs' dtypes, dbias and the log-sum-exp
float32. It is not the JAX package's `_attention_xla`, which multiplies in
bfloat16 and rounds p to bfloat16 before p v. The CUDA kernels read and
write bfloat16 themselves (no float32 copy of q, k or v is made): a product
of two bf16 values is exact in float32, so q k^T and g v^T are one bf16
tensor-core product each, and where the other operand is float32 (p, ds)
it is split into two bf16 terms, hi = bf16(x) and lo = bf16(x - hi).
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
    """The JAX package's `_fwd_kernel` in plain PyTorch, for all windows and
    heads at once: q, k and v widened to float32, explicit products, the
    bias and mask adds and the softmax in float32, the output rounded to
    q's dtype. For float32 inputs that is also `_attention_xla`; for
    bfloat16 ones it is the Pallas kernel's contract, not `_attention_xla`'s
    (bfloat16 products, p rounded to bfloat16). The CPU path and the tests
    use it; the CUDA path never does."""
    p = _probabilities(q.float(), k.float(), bias, mask)
    return torch.matmul(p, v.float()).to(q.dtype)


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
    heads at once: q, k, v and g widened to float32, p recomputed in
    float32, then dv = p^T g, dp = g v^T, ds = p (dp - rowsum(dp p)),
    dq = ds k scale, dk = ds^T q scale and dbias = the sum of ds over the
    windows, all in float32. Returns (dq, dk, dv, dbias) rounded to the
    dtypes of q, k, v and bias (the Pallas kernel's contract for bfloat16
    too). The CPU path and the tests use it; the CUDA path never does."""
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


# the element types of q, k, v and g that the kernels are built for
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_inputs(io, floats, what):
    """Tensors as the kernels read them: a view with the neg (or conj) bit
    set is resolved to a tensor of its values, since the kernels read raw
    memory. `io` (q, k, v and, in the backward, g) share one dtype, float32
    or bfloat16; `floats` (bias, mask, the forward's output and lse in the
    backward; None where absent) are float32. All contiguous and 16-byte
    aligned, or raise. Returns (io, floats), resolved."""
    io = [t.resolve_conj().resolve_neg() for t in io]
    floats = [None if t is None else t.resolve_conj().resolve_neg()
              for t in floats]
    present = io + [t for t in floats if t is not None]
    if (len({t.dtype for t in io}) != 1 or io[0].dtype not in KERNEL_DTYPES
            or any(t.dtype != torch.float32 for t in present[len(io):])):
        raise TypeError(
            f"{what}'s kernel takes q, k, v (and g) of one dtype, float32 or "
            "bfloat16, with a float32 bias, mask, out and lse; got "
            + ", ".join(str(t.dtype) for t in present))
    if not all(t.is_contiguous() for t in present):
        raise ValueError(f"{what}'s kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in present):
        raise ValueError(f"{what}'s kernel needs 16-byte aligned inputs")
    return io, floats


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
    lib.window_attn_bf16_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.window_attn_bf16_launch.restype = ctypes.c_int
    for fn in (lib.window_attn_blocks_per_sm,
               lib.window_attn_bf16_blocks_per_sm):
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    lib.window_attn_error_string.argtypes = [ctypes.c_int]
    lib.window_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    from dl_swin_gan_tpu_torch.kernels import _build

    lib = _build.load("window_attn_bwd").cdll
    for fn in (lib.window_attn_bwd_launch, lib.window_attn_bwd_bf16_launch):
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.window_attn_bwd_bf16_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.window_attn_bwd_bf16_blocks_per_sm.restype = ctypes.c_int
    lib.window_attn_bwd_bf16_work.argtypes = [ctypes.c_int] * 4
    lib.window_attn_bwd_bf16_work.restype = ctypes.c_longlong
    lib.window_attn_bwd_error_string.argtypes = [ctypes.c_int]
    lib.window_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def blocks_per_sm(D: int, dtype: torch.dtype = torch.float32) -> int:
    """Forward-kernel blocks of q's dtype `dtype` that fit one SM of the
    current card at head_dim D (built on first use)."""
    lib = _library()
    n = (lib.window_attn_bf16_blocks_per_sm(D) if dtype == torch.bfloat16
         else lib.window_attn_blocks_per_sm(D))
    if n < 0:
        raise RuntimeError(f"occupancy query failed at head_dim {D}")
    return n


# the bf16 backward's launches, in order (window_attn_bwd.cu): delta, dk
# and dv, dbias with dq's partial sums over the key tiles, dq
BF16_BWD_PASSES = ("delta", "kv", "dbias", "dq_sum")


def bwd_bf16_blocks_per_sm(D: int) -> dict:
    """{pass: blocks that fit one SM} of the bf16 backward's launches at
    head_dim D (built on first use)."""
    fn = _bwd_library().window_attn_bwd_bf16_blocks_per_sm
    blocks = {name: fn(D, i) for i, name in enumerate(BF16_BWD_PASSES)}
    if min(blocks.values()) < 0:
        raise RuntimeError(f"occupancy query failed at head_dim {D}")
    return blocks


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def window_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         with_lse: bool = True):
    """(out, lse, out32): the forward kernel on CUDA tensors. With
    `with_lse`, lse [W, H, N] is each row's float32 log-sum-exp and out32
    the output in float32 (out itself for float32 inputs; for bfloat16 ones
    a second store of the unrounded output): what window_attention_bwd's
    kernel reads. Without it both are None."""
    _check(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention has no kernel for {q.device}")
    (q, k, v), (bias, mask) = _kernel_inputs([q, k, v], [bias, mask],
                                             "window_attention")
    W, H, N, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = out32 = None
    if with_lse:
        lse = torch.empty((W, H, N), dtype=torch.float32, device=q.device)
        out32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                 if bf16 else out)
    if q.numel() == 0:
        return out, lse, out32
    _check_kernel_shape(q, "window_attention")
    if N > _MAX_TOKENS:
        raise ValueError(f"window_attention's kernel takes at most "
                         f"{_MAX_TOKENS} tokens a window; got {N}")
    lib = _library()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            _ptr(mask), out.data_ptr())
    tail = (W, H, N, D, 1 if mask is None else mask.shape[0], D ** -0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if bf16:
            err = lib.window_attn_bf16_launch(*head, _ptr(out32), _ptr(lse),
                                              *tail, stream)
        else:
            err = lib.window_attn_launch(*head, _ptr(lse), *tail, stream)
    if err != 0:
        raise RuntimeError("window_attention kernel launch failed: "
                           + lib.window_attn_error_string(err).decode())
    window_attention.launches += 1
    return out, lse, out32


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         g: torch.Tensor, out: Optional[torch.Tensor] = None,
                         lse: Optional[torch.Tensor] = None):
    """(dq, dk, dv, dbias) for the cotangent g of window_attention's output:
    the backward kernel on the GPU, which reads the forward's float32 output
    `out` (window_attention_fwd's out32) and its row log-sum-exp `lse`
    [W, H, N]; the plain version on the CPU, which recomputes everything
    and reads neither. g has q's dtype."""
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
    (q, k, v, g), (bias, mask, out, lse) = _kernel_inputs(
        [q, k, v, g], [bias, mask, out, lse], "window_attention_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:    # no window: dbias sums nothing
        return dq, dk, dv, torch.zeros_like(bias)
    dbias = torch.empty_like(bias)    # the kernel writes every element
    _check_kernel_shape(q, "window_attention_bwd")
    lib = _bwd_library()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            _ptr(mask), g.data_ptr(), out.data_ptr(), lse.data_ptr())
    tail = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), W,
            H, N, D, 1 if mask is None else mask.shape[0], D ** -0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            # each row's delta and dq's partial sums over the key tiles;
            # every pass recomputes ds, so no [W, H, N, N] scratch
            work = torch.empty(lib.window_attn_bwd_bf16_work(W, H, N, D),
                               dtype=torch.float32, device=q.device)
            err = lib.window_attn_bwd_bf16_launch(*head, work.data_ptr(),
                                                  *tail, stream)
        else:
            # each window's ds, written once by the kv pass, read back by
            # the dq pass and summed over the windows in order by the dbias
            # pass
            ds = torch.empty((W, H, N, N), dtype=torch.float32,
                             device=q.device)
            err = lib.window_attn_bwd_launch(*head, ds.data_ptr(), *tail,
                                             stream)
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
            out = window_attention_plain(q, k, v, bias, mask)
            saved = ()
        else:
            out, lse, out32 = window_attention_fwd(q, k, v, bias, mask,
                                                   with_lse=True)
            saved = (out32, lse)
        ctx.has_mask = mask is not None
        ctx.save_for_backward(q, k, v, bias, *saved,
                              *(() if mask is None else (mask,)))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, *rest = ctx.saved_tensors
        out = lse = None
        if q.device.type != "cpu":
            out, lse = rest[:2]
        mask = rest[-1] if ctx.has_mask else None
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


def window_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor], mesh,
                             axis: str = "data") -> torch.Tensor:
    """Context-parallel window attention (the JAX package's
    `window_attention_sharded`, a shard_map there): the window axis of the
    global q, k and v [W, H, N, D] is split over the ranks of a mesh axis
    (`parallel/mesh.py make_mesh`), and this rank runs `window_attention`,
    the hand kernel, on its W/n contiguous windows and returns their
    output [W/n, H, N, D]. Windows attend independently, so nothing is
    exchanged; the shift happens outside. W % n != 0 raises.

    The shift mask [nW, N, N] is periodic over the windows: when each
    rank's first window is a multiple of nW ((W/n) % nW == 0) every rank
    takes it whole; otherwise each rank takes the rows of its own windows
    ([W/n, N, N]; the JAX package tiles the mask over W there)."""
    from dl_swin_gan_tpu_torch.parallel.mesh import axis_size

    W = q.shape[0]
    n = axis_size(mesh, axis)
    if W % n:
        raise ValueError(f"window count {W} not divisible by {axis}={n}")
    m = W // n
    start = mesh.get_local_rank(axis) * m
    local = [t[start:start + m] for t in (q, k, v)]
    if mask is not None and m % mask.shape[0]:
        rows = torch.arange(start, start + m, device=mask.device)
        mask = mask[rows % mask.shape[0]]
    return window_attention(*local, bias, mask)


# kernel launches so far in this process; chip_smoke.py zeroes and reads them
window_attention.launches = 0
window_attention_bwd.launches = 0
