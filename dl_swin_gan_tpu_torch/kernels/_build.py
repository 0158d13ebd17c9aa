"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) at first use, into `kernels/_build/<name>-<hash>/` (listed
in `.gitignore`). The hash covers the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is built
when a module is imported: the CPU paths never call `load`.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

from dl_swin_gan_tpu_torch.utils.tracing import phase

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was loaded
    log: str               # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def load(name: str) -> Library:
    """Compile (if needed) and load `csrc/<name>.cu`; raises if the build
    fails. nvcc's run is the `kernels.build` phase (utils/tracing.py)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):    # the shared device code
        digest.update(header.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "build.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        with phase("kernels.build") as built:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
        seconds = built.seconds
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)   # atomic: a reader never sees half a file
    log = log_path.read_text() if log_path.exists() else ""
    return Library(ctypes.CDLL(str(lib_path)), lib_path, seconds, log)
