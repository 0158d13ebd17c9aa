#!/usr/bin/env python3
"""Time the window-attention forward kernel against another version of its
source, in one process on one GPU.

    python3 compare_attn_fwd.py --old path/to/window_attn.cu \
        [--old LABEL=path/to/other.cu ...]

Each `--old` is a source with this one's C interface (`window_attn_launch`),
labelled `old` (the first) or `old2`, `old3`, ... unless given as
LABEL=path: the parent's, or a design to time beside the kept one. Every
source is built with the port's nvcc flags and `-I` on `kernels/csrc`, so
a copy kept elsewhere finds the shared headers; ptxas's registers and
spills are printed for each, and the blocks per SM where the source
exports `window_attn_blocks_per_sm`. All versions run at the full-width
Swin block's shapes (N = 448, D = 20, H = 8, W = 12 per slice), batch 1
and 4, with and without the shift mask, in turns old ..., new, new, ...,
old, each through the same ctypes call (no lse, as the serving path calls
it). Each is held against the plain version: the output within
1e-4 of max |plain| (as chip_smoke.py holds it), and its row log-sum-exp
within 1e-5 of max |lse| of torch.logsumexp over the plain scores. Times
are CUDA-event medians (chip_smoke.cuda_ms, L2 flushed) and device time by
torch.profiler; SDPA with the float mask bias + mask is timed beside them.
The numbers go to standard output and, as JSON, to --out.

`--probe` first measures what bounds the kernel's products on this card:
`mma.sync.m16n8k8` with TF32 operands (as mma_tf32.cuh issues it), its
latency along one dependent chain (one warp, clock64) and its rate with
every SM full (one block of 16 warps an SM, 8 independent chains each),
in mma per SM
per cycle and TFLOP/s by CUDA events, with the SM clock the kernel saw
(clock64 against the global timer).
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
BUILD = ROOT / "runs" / "compare_attn_fwd"
LSE_REL_TOL = 1e-5


def _bind(lib):
    lib.window_attn_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.window_attn_launch.restype = ctypes.c_int
    return lib


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build(source, label):
    """A source built with the port's nvcc flags and loaded by ctypes, and
    its ptxas lines."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD / f"libwindow_attn_{label}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(lib_path), str(source)],
                          capture_output=True, text=True)
    CS.check(proc.returncode == 0, f"nvcc failed for {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib_path)), _ptxas(proc.stdout + proc.stderr)


def old_sources(specs):
    """{label: path} of the --old sources: LABEL=path, or a bare path
    labelled old, old2, ..."""
    sources = {}
    for i, spec in enumerate(specs):
        label, _, path = spec.rpartition("=")
        label = label or ("old" if i == 0 else f"old{i + 1}")
        CS.check(label != "new" and label not in sources,
                 f"--old label {label!r} is taken")
        sources[label] = Path(path)
    return sources


def blocks_per_sm(lib, D):
    try:
        fn = lib.window_attn_blocks_per_sm
    except AttributeError:       # a source that does not export it
        return None
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(D)


def call(lib, q, k, v, bias, mask, lse=None):
    W, H, N, D = q.shape
    out = torch.empty_like(q)
    err = lib.window_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), W, H, N, D,
        1 if mask is None else mask.shape[0], D ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    CS.check(err == 0, f"kernel launch failed: {err}")
    return out


PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include "mma_tf32.cuh"

__device__ __forceinline__ long long nanoseconds() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int Chains>
__global__ void mma_probe(float* out, long long* cycles, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + threadIdx.x + i);
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f + threadIdx.x);
  float c[Chains][4] = {};
  __syncthreads();
  const long long n0 = nanoseconds(), t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < Chains; ++i) mma(c[i], a, b);
  const long long t1 = clock64(), n1 = nanoseconds();
  float s = 0.f;
  for (int i = 0; i < Chains; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) {
    cycles[2 * blockIdx.x] = t1 - t0;
    cycles[2 * blockIdx.x + 1] = n1 - n0;
  }
}

extern "C" int mma_probe_launch(int chains, int blocks, int threads,
                                int iters, void* out, void* cycles) {
  float* o = static_cast<float*>(out);
  long long* c = static_cast<long long*>(cycles);
  if (chains == 1)
    mma_probe<1><<<blocks, threads>>>(o, c, iters);
  else
    mma_probe<8><<<blocks, threads>>>(o, c, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def probe():
    """mma.sync m16n8k8 TF32: cycles per mma along one dependent chain, and
    mma per SM per cycle and TFLOP/s with every SM full."""
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / "mma_probe.cu"
    src.write_text(PROBE_SOURCE)
    lib, _ = build(src, "mma_probe")
    lib.mma_probe_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.mma_probe_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, chains, blocks, threads, iters in (
            ("latency", 1, 1, 32, 4096),
            ("rate", 8, sms, 512, 4096)):
        res = torch.empty(blocks * threads, device="cuda")
        cycles = torch.zeros((blocks, 2), dtype=torch.int64, device="cuda")

        def run():
            err = lib.mma_probe_launch(chains, blocks, threads, iters,
                                       res.data_ptr(), cycles.data_ptr())
            CS.check(err == 0, f"probe launch failed: {err}")

        ms = CS.cuda_ms(run, runs=5)
        mma = blocks * (threads // 32) * chains * iters
        cyc, ns = cycles.double().mean(0).tolist()
        out[label] = {
            "sm_clock_ghz": cyc / ns,
            "cycles_per_mma_per_warp": cyc / (chains * iters),
            "mma_per_sm_per_cycle": mma / sms / cyc,
            "tflops": mma * 2 * 16 * 8 * 8 / ms / 1e9, "ms": ms}
        print(f"probe mma.sync m16n8k8 tf32 {label}: "
              + ", ".join(f"{n} {v:.4f}" for n, v in out[label].items()))
    return out


def device_ms(fn):
    """torch.profiler's device ms per fn() call."""
    return sum(CS.per_call(CS.device_ms_by_kernel(fn)).values())


def plain_lse(q, k, bias, mask):
    W, H, N, D = q.shape
    s = torch.matmul(q * D ** -0.5, k.transpose(-1, -2)) + bias
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(W // nW, nW, H, N, N) + mask[None, :, None]
             ).reshape(s.shape)
    return torch.logsumexp(s, -1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", action="append", required=True,
                        help="another window_attn.cu, as a path or "
                        "LABEL=path (repeatable)")
    parser.add_argument("--probe", action="store_true",
                        help="measure mma.sync's TF32 latency and rate first")
    parser.add_argument("--out", type=Path,
                        default=BUILD / "compare_attn_fwd.json",
                        help="where the JSON results go")
    args = parser.parse_args()
    CS.check(torch.cuda.is_available(), "no CUDA device")
    CS.phase_device()

    results = {"probe": probe() if args.probe else None}
    N = CS.SWIN_WINDOW[0] * CS.SWIN_WINDOW[1] * CS.SWIN_WINDOW[2]
    H, D = CS.SWIN_HEADS, CS.SWIN_HEAD_DIM
    new = _build.load("window_attn")
    libs = {label: build(path, label)
            for label, path in old_sources(args.old).items()}
    libs["new"] = (new.cdll, _ptxas(new.log))
    for lib, _ in libs.values():
        _bind(lib)
    builds = {}
    for name, (lib, ptxas) in libs.items():
        builds[name] = {"ptxas": ptxas, "blocks_per_sm": blocks_per_sm(lib, D)}
        print(f"build {name}: blocks per SM at D={D} "
              f"{builds[name]['blocks_per_sm']}")
        for ln in ptxas:
            print(f"  ptxas: {ln}")
    others = list(libs)[:-1]             # the --old sources
    turns = others + ["new", "new"] + others[::-1]

    shift = torch.from_numpy(compute_shift_mask(
        *CS.SWIN_GRID, CS.SWIN_WINDOW, CS.SWIN_SHIFT)).cuda()
    nW = shift.shape[0]
    rng = np.random.RandomState(CS.SEED + 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results.update(builds=builds, points={})
    for B in (1, 4):
        W = nW * B
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (W, H, N, D)).astype(np.float32)).cuda() for _ in range(3))
        bias = torch.from_numpy(
            0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).cuda()
        for masked in (True, False):
            m = shift if masked else None
            plain = WA.window_attention_plain(q, k, v, bias, m)
            ref_lse = plain_lse(q, k, bias, m)
            scale = plain.abs().max().item()
            row = {}
            for name, (lib, _) in libs.items():
                lse = torch.empty((W, H, N), dtype=torch.float32,
                                  device="cuda")
                out = call(lib, q, k, v, bias, m, lse)
                rel = (out - plain).abs().max().item() / scale
                lse_rel = ((lse - ref_lse).abs().max()
                           / ref_lse.abs().max()).item()
                CS.check(torch.isfinite(out).all().item(),
                         f"{name} output not finite")
                CS.check(rel <= CS.KERNEL_REL_TOL,
                         f"{name} vs plain rel err {rel:.3e} at B={B} "
                         f"mask={masked}")
                CS.check(lse_rel <= LSE_REL_TOL,
                         f"{name} lse vs plain rel err {lse_rel:.3e} at "
                         f"B={B} mask={masked}")
                row[name] = {"rel_err": rel, "lse_rel_err": lse_rel, "ms": []}
            del out, lse
            for name in turns:
                lib = libs[name][0]
                row[name]["ms"].append(
                    CS.cuda_ms(lambda: call(lib, q, k, v, bias, m)))
            for name, (lib, _) in libs.items():
                row[name]["device_ms"] = device_ms(
                    lambda: call(lib, q, k, v, bias, m))
            full = bias[None] + (shift.repeat(B, 1, 1)[:, None]
                                 if masked else 0)
            full = full.expand(W, H, N, N).contiguous()

            def library():
                return sdpa(q, k, v, attn_mask=full)

            row["sdpa"] = {
                "ms": [CS.cuda_ms(library)],
                "device_ms": device_ms(library)}
            del full
            flops, nbytes = CS._attention_work(W, H, N, D, nW if masked else 0)
            row["bound_ms"] = {
                "3xTF32": max(flops / (CS.TF32_FLOPS / 3),
                              nbytes / CS.HBM_BYTES_PER_S) * 1e3,
                "fp32_fma": max(flops / CS.FP32_FLOPS,
                                nbytes / CS.HBM_BYTES_PER_S) * 1e3}
            key = f"B={B} mask={'shift' if masked else 'none'}"
            results["points"][key] = row
            print(f"compare {key}: " + "; ".join(
                f"{name} ms {', '.join(f'{t:.4f}' for t in r['ms'])} device "
                f"{r['device_ms']:.4f}"
                + (f" rel {r['rel_err']:.3e} lse rel {r['lse_rel_err']:.3e}"
                   if "rel_err" in r else "")
                for name, r in row.items() if name != "bound_ms")
                + "; bound ms " + ", ".join(
                    f"{n} {t:.4f}" for n, t in row["bound_ms"].items()))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
