#!/usr/bin/env python3
"""Time the window-attention backward kernel against another version of its
source, in one process on one GPU.

    python3 compare_attn_bwd.py --old path/to/window_attn_bwd.cu

`--old` is a source with this one's C interface (`window_attn_bwd_launch`,
with a `ds` scratch of [W, H, N, N] floats between lse and dq). Both versions run at the full-width
Swin block's shapes (N = 448, D = 20, H = 8, W = 12 per slice), batch 1 and
4, with and without the shift mask, in turns old, new, new, old. Each is
held against the plain version (1e-4, as chip_smoke.py holds it), timed by
CUDA events (chip_smoke.cuda_ms, L2 flushed) and split by launch with
torch.profiler; SDPA's backward is timed beside them. The numbers go to
standard output and, as JSON, to --out.
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
from dl_swin_gan_tpu_torch.utils.device import use_ieee_fp32

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "runs" / "compare_attn_bwd"


def build_old(source):
    """The old source built with the port's nvcc flags, loaded by ctypes."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD / "libwindow_attn_bwd_old.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(source)],
                          capture_output=True, text=True)
    CS.check(proc.returncode == 0, f"nvcc failed for {source}:\n{proc.stderr}")
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  old ptxas: {ln.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    lib.window_attn_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                       ctypes.c_void_p])
    lib.window_attn_bwd_launch.restype = ctypes.c_int
    return lib


def old_bwd(lib, q, k, v, bias, mask, g, out, lse):
    W, H, N, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.zeros_like(bias)
    ds = torch.empty((W, H, N, N), dtype=torch.float32, device=q.device)
    err = lib.window_attn_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), g.data_ptr(),
        out.data_ptr(), lse.data_ptr(), ds.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), W, H, N, D,
        1 if mask is None else mask.shape[0], D ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    CS.check(err == 0, f"old kernel launch failed: {err}")
    return dq, dk, dv, dbias


def max_rel(grads, plain):
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(grads, plain))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="the other window_attn_bwd.cu")
    parser.add_argument("--out", type=Path,
                        default=BUILD / "compare_attn_bwd.json",
                        help="where the JSON results go")
    args = parser.parse_args()
    CS.check(torch.cuda.is_available(), "no CUDA device")
    CS.phase_device()
    old = build_old(args.old)
    _build.load("window_attn_bwd")

    N = CS.SWIN_WINDOW[0] * CS.SWIN_WINDOW[1] * CS.SWIN_WINDOW[2]
    H, D = CS.SWIN_HEADS, CS.SWIN_HEAD_DIM
    shift = torch.from_numpy(compute_shift_mask(
        *CS.SWIN_GRID, CS.SWIN_WINDOW, CS.SWIN_SHIFT)).cuda()
    nW = shift.shape[0]
    rng = np.random.RandomState(CS.SEED + 2)
    results = {}
    for B in (1, 4):
        W = nW * B
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (W, H, N, D)).astype(np.float32)).cuda() for _ in range(4))
        bias = torch.from_numpy(
            0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).cuda()
        for masked in (True, False):
            m = shift if masked else None
            out, lse, _ = WA.window_attention_fwd(q, k, v, bias, m)
            versions = {
                "old": lambda: old_bwd(old, q, k, v, bias, m, g, out, lse),
                "new": lambda: WA.window_attention_bwd(q, k, v, bias, m, g,
                                                       out, lse)}
            plain = WA.window_attention_bwd_plain(q, k, v, bias, m, g)
            row = {}
            grads = {}
            for name, fn in versions.items():
                grads[name] = fn()
                rel = max_rel(grads[name], plain)
                CS.check(rel <= CS.KERNEL_REL_TOL,
                         f"{name} vs plain rel err {rel:.3e}")
                row[name] = {"rel_err": rel, "ms": []}
            row["new"]["bitwise_equal_to_old"] = all(
                torch.equal(a, b) for a, b in zip(grads["old"], grads["new"]))
            del grads
            for name in ("old", "new", "new", "old"):
                row[name]["ms"].append(CS.cuda_ms(versions[name]))
            for name, fn in versions.items():
                row[name]["device_ms_by_launch"] = {
                    CS._short(n): t
                    for n, t in CS.per_call(
                        CS.device_ms_by_kernel(fn)).items()}
            library = CS.sdpa_backward(q, k, v, bias, m, g)
            row["sdpa_backward"] = {
                "ms": [CS.cuda_ms(library)],
                "device_ms": sum(CS.per_call(
                    CS.device_ms_by_kernel(library)).values())}
            del library
            key = f"B={B} mask={'shift' if masked else 'none'}"
            results[key] = row
            print(f"compare {key}: " + "; ".join(
                f"{name} ms {', '.join(f'{t:.4f}' for t in r['ms'])}"
                + (f" rel {r['rel_err']:.3e}" if "rel_err" in r else "")
                + (f" bitwise equal to old {r['bitwise_equal_to_old']}"
                   if "bitwise_equal_to_old" in r else "")
                + " device " + (", ".join(
                    f"{n} {t:.4f}" for n, t in
                    r["device_ms_by_launch"].items())
                    if "device_ms_by_launch" in r else f"{r['device_ms']:.4f}")
                for name, r in row.items()))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
