#!/usr/bin/env python3
"""Time the bf16 window-attention kernels, forward and backward, against
another version of their sources, in one process on one GPU; and check
that the float32 kernels give bitwise the same results as that version's.

    python3 compare_attn_bf16.py --old-csrc DIR [--out PATH]

DIR holds the other version's `window_attn.cu`, `window_attn_bwd.cu` and
their headers (e.g. `git archive` of a parent commit's
`dl_swin_gan_tpu_torch/kernels/csrc`), whose C interface is the one where
`window_attn_bwd_launch` and `window_attn_bwd_bf16_launch` both take a
`ds` scratch of [W, H, N, N] floats between lse and dq. Each source is
built with the port's nvcc flags and `-I DIR`; ptxas's registers and
spills are printed for each.

1. float32, at the full-width Swin block's shapes (N = 448, D = 20, H = 8,
   W = 12 per slice), batch 1 and 4, with and without the shift mask:
   out, lse, dq, dk, dv and dbias of this version equal to the other's,
   bit for bit.
2. bf16, at chip_smoke.py's six bf16 points (the Swin block at batch 1
   and 4, shifted and not, and SwinDiff's [10, 4, 384, 24], shifted and
   not): the forward as the serving path calls it (no lse) and as
   training does (lse and out32), in turns old, new, new, old; the
   backward likewise, "old" the other version's, "new" this version's
   (no [W, H, N, N] scratch). Every version is called through ctypes as
   it stands, without the port's wrapper, so that its checks do not
   count against either. Each is held against the plain versions with
   chip_smoke.py's bf16 limits, the new backward twice for bitwise-equal
   gradients, and the new kernels against what the wrapper returns, bit
   for bit. Times are CUDA-event medians of L2-flushed calls
   (chip_smoke.cuda_ms); beside them torch.profiler's device ms per
   launch of each kernel, the extra peak device memory of one call
   (torch.cuda.max_memory_allocated above what was allocated before it)
   and the blocks per SM of each bf16 launch.

The numbers go to standard output and, as JSON, to --out.
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as CS
from dl_swin_gan_tpu_torch.kernels import _build
from dl_swin_gan_tpu_torch.kernels import window_attn as WA
from dl_swin_gan_tpu_torch.models.swin import compute_shift_mask

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "runs" / "compare_attn_bf16"


def build_old(csrc):
    """The other version's forward and backward, built and loaded."""
    BUILD.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("window_attn", "window_attn_bwd"):
        path = BUILD / f"lib{name}_old.so"
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(path), str(csrc / f"{name}.cu")],
            capture_output=True, text=True)
        CS.check(proc.returncode == 0,
                 f"nvcc failed for the old {name}.cu:\n{proc.stderr}")
        for ln in (proc.stdout + proc.stderr).splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                print(f"  old {name} ptxas: {ln.strip()}")
        libs[name] = ctypes.CDLL(str(path))
    fwd, bwd = libs["window_attn"], libs["window_attn_bwd"]
    for fn in (fwd.window_attn_launch, fwd.window_attn_bf16_launch):
        fn.restype = ctypes.c_int
    fwd.window_attn_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    fwd.window_attn_bf16_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    for fn in (bwd.window_attn_bwd_launch, bwd.window_attn_bwd_bf16_launch):
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fwd, bwd


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def fwd_call(lib, q, k, v, bias, mask, with_lse):
    """(out, lse, out32) of either version's forward, called through ctypes
    as it stands (no wrapper), so that both are timed alike."""
    W, H, N, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = out32 = None
    if with_lse:
        lse = torch.empty((W, H, N), dtype=torch.float32, device=q.device)
        out32 = torch.empty(q.shape, dtype=torch.float32,
                            device=q.device) if bf16 else out
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            _ptr(mask), out.data_ptr())
    tail = (W, H, N, D, 1 if mask is None else mask.shape[0], D ** -0.5,
            _stream())
    if bf16:
        err = lib.window_attn_bf16_launch(*head, _ptr(out32), _ptr(lse),
                                          *tail)
    else:
        err = lib.window_attn_launch(*head, _ptr(lse), *tail)
    CS.check(err == 0, f"forward launch failed: {err}")
    return out, lse, out32


def old_bwd(lib, q, k, v, bias, mask, g, out, lse):
    """The other version's backward, with its [W, H, N, N] scratch."""
    W, H, N, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    ds = torch.empty((W, H, N, N), dtype=torch.float32, device=q.device)
    launch = (lib.window_attn_bwd_bf16_launch if q.dtype == torch.bfloat16
              else lib.window_attn_bwd_launch)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 _ptr(mask), g.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 ds.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 dbias.data_ptr(), W, H, N, D,
                 1 if mask is None else mask.shape[0], D ** -0.5, _stream())
    CS.check(err == 0, f"old backward launch failed: {err}")
    return dq, dk, dv, dbias


def new_bwd(q, k, v, bias, mask, g, out, lse):
    """This version's bf16 backward called through ctypes as it stands."""
    W, H, N, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    lib = WA._bwd_library()
    work = torch.empty(lib.window_attn_bwd_bf16_work(W, H, N, D),
                       dtype=torch.float32, device=q.device)
    err = lib.window_attn_bwd_bf16_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        _ptr(mask), g.data_ptr(), out.data_ptr(), lse.data_ptr(),
        work.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dbias.data_ptr(), W, H, N, D,
        1 if mask is None else mask.shape[0], D ** -0.5, _stream())
    CS.check(err == 0, f"new backward launch failed: {err}")
    return dq, dk, dv, dbias


def device_by_launch(fn):
    """{short kernel name: device ms per launch} of fn()."""
    return {CS._short(n): ms
            for n, (ms, _) in CS.device_ms_by_kernel(fn).items()}


def float32_bitwise(old_f, old_b):
    """Section 1: {point: True} where every output equals the other
    version's bit for bit; fails on the first that does not."""
    N = CS.SWIN_WINDOW[0] * CS.SWIN_WINDOW[1] * CS.SWIN_WINDOW[2]
    H, D = CS.SWIN_HEADS, CS.SWIN_HEAD_DIM
    shift = torch.from_numpy(compute_shift_mask(
        *CS.SWIN_GRID, CS.SWIN_WINDOW, CS.SWIN_SHIFT)).cuda()
    rng = np.random.RandomState(CS.SEED + 5)
    equal = {}
    for B in (1, 4):
        W = shift.shape[0] * B
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (W, H, N, D)).astype(np.float32)).cuda() for _ in range(4))
        bias = torch.from_numpy(
            0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).cuda()
        for m in (shift, None):
            key = f"B={B} mask={'none' if m is None else 'shift'}"
            out, lse, _ = WA.window_attention_fwd(q, k, v, bias, m)
            o_out, o_lse, _ = fwd_call(old_f, q, k, v, bias, m, True)
            grads = WA.window_attention_bwd(q, k, v, bias, m, g, out, lse)
            o_grads = old_bwd(old_b, q, k, v, bias, m, g, out, lse)
            torch.cuda.synchronize()
            for name, a, b in zip(("out", "lse", "dq", "dk", "dv", "dbias"),
                                  (out, lse, *grads), (o_out, o_lse,
                                                       *o_grads)):
                CS.check(torch.equal(a, b), f"float32 {name} differs from the "
                         f"old version's at {key}")
            equal[key] = True
            print(f"float32 {key}: out, lse, dq, dk, dv, dbias bitwise equal "
                  "to the old version's")
    return equal


def _errors(outs, plain):
    """{name: rel error} against the plain versions, with chip_smoke.py's
    bf16 limits checked: one bf16 ulp plus 1e-4 of the largest and rel L2
    BF16_KERNEL_REL_L2 for bf16 outputs, 1e-4 of the largest for float32."""
    rels = {}
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), outs, plain):
        if a.dtype == torch.float32:
            rels[name] = ((a - b).abs().max() / b.abs().max()).item()
            ok = rels[name] <= CS.KERNEL_REL_TOL
        else:
            _, rels[name], excess = CS._bf16_errors(a, b)
            ok = excess <= 0 and rels[name] <= CS.BF16_KERNEL_REL_L2
        CS.check(torch.isfinite(a.float()).all().item() and ok,
                 f"{name} rel {rels[name]:.3e} past the limit")
    return rels


def bf16_point(old_f, old_b, tag, W, H, N, D, mask, rng):
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (W, H, N, D)).astype(np.float32)).cuda().bfloat16()
        for _ in range(4))
    bias = torch.from_numpy(
        0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).cuda()
    plain_out = WA.window_attention_plain(q, k, v, bias, mask)
    plain = WA.window_attention_bwd_plain(q, k, v, bias, mask, g)
    row = {"shape": [W, H, N, D]}

    new_f = WA._library()
    fwd = {"old": lambda lse: fwd_call(old_f, q, k, v, bias, mask, lse),
           "new": lambda lse: fwd_call(new_f, q, k, v, bias, mask, lse)}
    saved = {}
    for name, fn in fwd.items():
        out, lse, out32 = fn(True)
        if name == "new":   # the wrapper runs the same kernel
            CS.check(all(torch.equal(a, b) for a, b in zip(
                (out, lse, out32),
                WA.window_attention_fwd(q, k, v, bias, mask))),
                f"the wrapper's forward differs at {tag}")
        _, rel, excess = CS._bf16_errors(out, plain_out)
        CS.check(excess <= 0 and rel <= CS.BF16_KERNEL_REL_L2
                 and torch.equal(out, out32.bfloat16()),
                 f"{name} forward at {tag}: rel L2 {rel:.3e}")
        row[f"fwd_{name}"] = {"rel_err": rel, "ms": [], "train_ms": []}
        saved[name] = (out32, lse)
    for name in ("old", "new", "new", "old"):
        row[f"fwd_{name}"]["ms"].append(CS.cuda_ms(lambda: fwd[name](False)))
        row[f"fwd_{name}"]["train_ms"].append(
            CS.cuda_ms(lambda: fwd[name](True)))
    for name in fwd:
        row[f"fwd_{name}"]["device_ms_by_launch"] = device_by_launch(
            lambda: fwd[name](False))

    out32, lse = saved["new"]
    bwd = {"old": lambda: old_bwd(old_b, q, k, v, bias, mask, g, *saved["old"]),
           "new": lambda: new_bwd(q, k, v, bias, mask, g, out32, lse)}
    for name, fn in bwd.items():
        grads = fn()
        row[f"bwd_{name}"] = {"rel_err_by_grad": _errors(grads, plain),
                              "ms": []}
        if name == "new":   # repeatable, and what the wrapper runs
            CS.check(all(torch.equal(a, b) for a, b in zip(grads, fn())),
                     f"new backward not repeatable at {tag}")
            CS.check(all(torch.equal(a, b) for a, b in zip(
                grads, WA.window_attention_bwd(q, k, v, bias, mask, g, out32,
                                               lse))),
                     f"the wrapper's backward differs at {tag}")
        del grads
    for name in ("old", "new", "new", "old"):
        row[f"bwd_{name}"]["ms"].append(CS.cuda_ms(bwd[name]))
    for name, fn in bwd.items():
        row[f"bwd_{name}"]["device_ms_by_launch"] = device_by_launch(fn)
        row[f"bwd_{name}"]["extra_peak_mb"] = CS.extra_peak_mb(fn)

    nW = 0 if mask is None else mask.shape[0]
    for side, work in (("fwd", CS._attention_work),
                       ("bwd", CS._attention_bwd_work)):
        flops, nbytes = work(W, H, N, D, nW, io_bytes=2)
        row[f"{side}_bound_ms"] = max(flops / CS.BF16_FLOPS,
                                      nbytes / CS.HBM_BYTES_PER_S) * 1e3
    print(f"bf16 {tag} [{W},{H},{N},{D}]: " + "; ".join(
        f"{key} ms {', '.join(f'{t:.4f}' for t in r['ms'])}"
        + (f" train {', '.join(f'{t:.4f}' for t in r['train_ms'])}"
           if "train_ms" in r else "")
        + (f" rel {r['rel_err']:.3e}" if "rel_err" in r else
           " rel " + ", ".join(f"{n} {x:.3e}"
                               for n, x in r["rel_err_by_grad"].items()))
        + (f" extra peak {r['extra_peak_mb']:.1f} MB"
           if "extra_peak_mb" in r else "")
        + " device " + ", ".join(f"{n} {t:.4f}" for n, t in
                                 r["device_ms_by_launch"].items())
        for key, r in row.items() if isinstance(r, dict))
        + f"; bound fwd {row['fwd_bound_ms']:.4f} bwd "
        f"{row['bwd_bound_ms']:.4f}")
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-csrc", type=Path, required=True,
                        help="the other version's kernels/csrc directory")
    parser.add_argument("--out", type=Path,
                        default=BUILD / "compare_attn_bf16.json",
                        help="where the JSON results go")
    args = parser.parse_args()
    CS.check(torch.cuda.is_available(), "no CUDA device")
    CS.phase_device()
    old_f, old_b = build_old(args.old_csrc.resolve())
    for name in ("window_attn", "window_attn_bwd"):
        for ln in _build.load(name).log.splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                print(f"  new {name} ptxas: {ln.strip()}")
    blocks = {D: {"fwd": WA.blocks_per_sm(D, torch.bfloat16),
                  **WA.bwd_bf16_blocks_per_sm(D)} for D in (20, 24)}
    print(f"bf16 blocks per SM: {blocks}")
    results = {"blocks_per_sm": blocks,
               "float32_bitwise": float32_bitwise(old_f, old_b),
               "bf16": {}}
    rng = np.random.RandomState(CS.SEED + 4)
    for tag, W, H, N, D, mask in CS._bf16_attention_cases():
        results["bf16"][tag] = bf16_point(old_f, old_b, tag, W, H, N, D,
                                          mask, rng)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
