#!/usr/bin/env python3
"""Time the SENSE-normal and block-LLR normal kernels against other versions
of their sources, in one process on one GPU.

    python3 compare_coil_normal.py --old-csrc DIR

DIR holds another version's `sense_normal.cu`, `llr_normal.cu` and
`coil_normal.cuh` (a `.cu` includes its header from its own directory), with
this version's C interface (`sense_normal_launch`, `llr_normal_launch`). A
version whose coil pass runs on the tensor cores also includes
`mma_tf32.cuh`; one that does reads `coil_tables`' split DFT tables, one
that does not reads the complex64 matrices. For example, the sources of a
commit:

    mkdir -p runs/old_csrc && for f in sense_normal.cu llr_normal.cu \
        coil_normal.cuh mma_tf32.cuh; do \
        git show REV:dl_swin_gan_tpu_torch/kernels/csrc/$f \
        > runs/old_csrc/$f 2>/dev/null || rm runs/old_csrc/$f; done

Every version runs at chip_smoke.py's shapes: `sense_normal` at batch 1 and
4 on the 12x parity mask (T=20, 180x64, C=8, E=2), and `llr_normal` 'pre'
and 'post' at one and two systems on the DSLR training point. Each is held
against the plain version (1e-4, as chip_smoke.py holds it), timed by CUDA
events (chip_smoke.cuda_ms, L2 flushed) in turns old, new, new, old and
split by launch with torch.profiler; the cuFFT chain is timed beside them.
With --phases, this version is also built with its phase probe and
coil_normal_kernel's cycles per phase are read at batch 1 and 4. The
numbers go to standard output and, as JSON, to --out.
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
from dl_swin_gan_tpu_torch.kernels import llr_normal as LN
from dl_swin_gan_tpu_torch.kernels import sense_normal as SN
from dl_swin_gan_tpu_torch.ops.sense import _adjoint_impl, _forward_impl
from dl_swin_gan_tpu_torch.utils.headline import headline_shape

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "runs" / "compare_coil_normal"
SOURCES = ("sense_normal", "llr_normal")


def build_old(csrc):
    """{source: the CDLL} of another version's two sources, built with the
    port's nvcc flags, both at once."""
    out = BUILD / "old"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(Path(csrc) / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        CS.check(proc.returncode == 0, f"nvcc failed for old {name}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  old {name} ptxas: {ln.strip()}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return {"sense_normal": SN.bind(libs["sense_normal"]),
            "llr_normal": LN.bind(libs["llr_normal"])}


PHASES = ("expansion and row flags", "row list", "y-DFT", "x-DFT and weight",
          "inverse x-DFT", "inverse y-DFT")


def phases(rng):
    """This version's coil_normal_kernel built with its phase probe
    (-DCOIL_NORMAL_PHASES): mean clock64 cycles per block of each phase, at
    batch 1 and 4 of the headline inputs."""
    out = BUILD / "phases"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libsense_normal.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DCOIL_NORMAL_PHASES", "-o",
         str(lib_path), str(_build.CSRC / "sense_normal.cu")],
        capture_output=True, text=True)
    CS.check(proc.returncode == 0, f"nvcc failed (phases):\n{proc.stderr}")
    lib = SN.bind(ctypes.CDLL(str(lib_path)))
    lib.coil_normal_phases.argtypes = [ctypes.c_void_p]
    cycles = np.zeros((4096, len(PHASES)), np.int64)
    results = {}
    for B in (1, 4):
        x, maps, w, _, _ = CS.sense_inputs(rng, B)
        tables = SN.coil_tables(*w.shape[2:], x.device)
        SN.launch(lib, x, maps, w, *tables)
        torch.cuda.synchronize()
        CS.check(lib.coil_normal_phases(cycles.ctypes.data) == 0, "probe")
        SN.launch(lib, x, maps, w, *tables)
        torch.cuda.synchronize()
        CS.check(lib.coil_normal_phases(cycles.ctypes.data) == 0, "probe")
        blocks = cycles[:maps.shape[2] * w.shape[1] * B]
        mean = blocks.mean(0)
        results[f"B={B}"] = dict(zip(PHASES, mean.tolist()),
                                 total=float(blocks.sum(1).mean()))
        print(f"phases B={B}: mean cycles per block: " + ", ".join(
            f"{n} {v:.0f} ({v / mean.sum():.1%})" for n, v in
            zip(PHASES, mean)) + f"; total {mean.sum():.0f}")
    return results


def rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def measure(versions, plain, library):
    """One point: each version's error, its event times in turns and its
    device ms by launch; the library call's times."""
    ref = plain()
    row = {}
    for name, fn in versions.items():
        rel = rel_err(fn(), ref)
        CS.check(rel <= CS.KERNEL_REL_TOL, f"{name} vs plain rel err {rel:.3e}")
        row[name] = {"rel_err": rel, "ms": []}
    for name in ("old", "new", "new", "old"):
        row[name]["ms"].append(CS.cuda_ms(versions[name]))
    for name, fn in versions.items():
        launches = row[name]["device_ms_by_launch"] = {}
        for n, t in CS.per_call(CS.device_ms_by_kernel(fn)).items():
            launches[CS._short(n)] = launches.get(CS._short(n), 0.0) + t
    row["library"] = {"rel_err": rel_err(library(), ref),
                      "ms": [CS.cuda_ms(library)],
                      "device_ms": sum(CS.per_call(
                          CS.device_ms_by_kernel(library)).values())}
    return row


def show(key, row):
    parts = []
    for name, r in row.items():
        launches = r.get("device_ms_by_launch")
        device = (", ".join(f"{n} {t:.4f}" for n, t in launches.items())
                  + f" = {sum(launches.values()):.4f}" if launches
                  else f"{r['device_ms']:.4f}")
        parts.append(f"{name} ms {', '.join(f'{t:.4f}' for t in r['ms'])} "
                     f"rel {r['rel_err']:.3e} device {device}")
    print(f"compare {key}: " + "; ".join(parts))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-csrc", type=Path, required=True,
                        help="a directory of the other version's sources")
    parser.add_argument("--phases", action="store_true",
                        help="also this version's cycles per phase of "
                        "coil_normal_kernel (its clock64 probe)")
    parser.add_argument("--out", type=Path,
                        default=BUILD / "compare_coil_normal.json",
                        help="where the JSON results go")
    args = parser.parse_args()
    CS.check(torch.cuda.is_available(), "no CUDA device")
    CS.phase_device()
    libs = {"old": build_old(args.old_csrc),
            "new": {"sense_normal": SN._library(),
                    "llr_normal": LN._library()}}
    split = {"old": (args.old_csrc / "mma_tf32.cuh").exists(), "new": True}
    T, Y, X, C, E = headline_shape()
    print(f"new coil_normal_kernel blocks per SM at {Y}x{X}: "
          f"{SN.blocks_per_sm(Y, X)}")

    def tables(tag, Y, X):
        """The DFT tables a version reads: the split ones or the complex64
        matrices."""
        dev = torch.device("cuda")
        if split[tag]:
            return SN.coil_tables(Y, X, dev)
        return SN.ortho_dft(Y, dev), SN.ortho_dft(X, dev)

    results = {}
    rng = np.random.RandomState(CS.SEED)
    for B in (1, 4):
        x, maps, w, maps6, m5 = CS.sense_inputs(rng, B)
        versions = {tag: (lambda lib=lib, tab=tables(tag, Y, X): SN.launch(
            lib["sense_normal"], x, maps, w, *tab)) for tag, lib in libs.items()}
        row = measure(versions, lambda: SN.sense_normal_plain(x, maps, w),
                      lambda: _adjoint_impl(_forward_impl(x, maps6, m5),
                                            maps6, m5))
        results[f"sense_normal B={B}"] = row
        show(f"sense_normal B={B}", row)

    op, maps, w2, c64, plain, library = CS.llr_inputs()
    for S in (1, 2):
        blk = c64(S, op.num_blocks, op.ne * op.block_size ** 2, T)
        for d_side in ("pre", "post"):
            versions = {tag: (lambda lib=lib, tab=tables(tag, Y, X): LN.launch(
                lib["llr_normal"], blk, maps, w2, op, d_side, *tab))
                for tag, lib in libs.items()}
            row = measure(versions, lambda: plain(blk, d_side),
                          lambda: library(blk, d_side))
            key = f"llr_normal {d_side} S={S}"
            results[key] = row
            show(key, row)
    if args.phases:
        results["phases"] = phases(rng)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
