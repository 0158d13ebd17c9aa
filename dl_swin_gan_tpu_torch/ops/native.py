"""ctypes loader for the native (C) VDkt mask generator.

Counterpart of `ops/native.py` in the JAX package. The VDkt mask is the one
sequential per-example hot path on the host; the repo's `native/vdkt.c`
implements it with a bit-exact reimplementation of numpy's legacy
RandomState (MT19937), so a seeded mask equals the Python path's
(`ops/masks.py`) sample for sample.

The library is compiled at first use with `cc -O2 -shared -fPIC` into
`kernels/_build/vdkt-<hash>/` (listed in `.gitignore`), keyed by the source
and the flags as `kernels/_build.py` keys the CUDA kernels. Callers take the
Python path when DL_SWIN_GAN_NO_NATIVE=1, or, with a logged warning, on a
machine with no C compiler; a compiler that fails to build the source, or a
library that fails to load, raises.
"""

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parents[2] / "native" / "vdkt.c"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "kernels" / "_build"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
COMPILERS = ("cc", "gcc", "clang")

_BUILD_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CC_FLAGS).encode())
    return BUILD_ROOT / f"vdkt-{digest.hexdigest()[:16]}" / "libvdkt.so"


def _build() -> Optional[Path]:
    """The built library's path; None when no C compiler is found."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    cc = next((shutil.which(c) for c in COMPILERS if shutil.which(c)), None)
    if cc is None:
        return None
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"libvdkt.so.{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SRC), "-lm"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed for {SRC} (exit {proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib_path)      # atomic: a reader never sees half a file
    logger.info("built native vdkt library with %s -> %s", cc, lib_path)
    return lib_path


def get_vdkt_lib():
    """The loaded library (building it at first use), or None: under
    DL_SWIN_GAN_NO_NATIVE=1, or without a C compiler."""
    if os.environ.get("DL_SWIN_GAN_NO_NATIVE") == "1":
        return None
    return _load()


@functools.lru_cache(maxsize=None)
def _load():
    """Build (once, under a lock: the loaders' threads may ask together)
    and load the library; None without a C compiler."""
    with _BUILD_LOCK:
        so_path = _build()
    if so_path is None:
        logger.warning("no C compiler (%s) found: VDkt masks take the "
                       "Python path", ", ".join(COMPILERS))
        return None
    lib = ctypes.CDLL(str(so_path))
    lib.vdkt_mask.restype = ctypes.c_double
    lib.vdkt_mask.argtypes = [
        ctypes.POINTER(ctypes.c_float),                      # out
        ctypes.c_long, ctypes.c_long, ctypes.c_long,         # nkx, nky, nph
        ctypes.c_double, ctypes.c_double,                    # accel range
        ctypes.c_double, ctypes.c_double,                    # partial kx/ky
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,      # seed key
        ctypes.c_int,                                        # scalar_seed
    ]
    return lib


def _seed_key(seed: Union[int, Sequence[int], None]
              ) -> Tuple[np.ndarray, bool]:
    """Replicate numpy legacy RandomState seeding semantics: (the key
    words, whether the seed is one 32-bit scalar)."""
    if seed is None:
        # non-deterministic from OS entropy, as rng.seed(None) seeds the
        # Python path; numpy's global RNG would tie unseeded training
        # masks to whatever last seeded it
        return np.frombuffer(os.urandom(8), dtype=np.uint32).copy(), False
    if isinstance(seed, (int, np.integer)):
        if int(seed) < 0:
            # numpy RandomState raises; silently seeding from an empty key
            # would make the native path diverge from the Python path
            raise ValueError("Seed must be between 0 and 2**32 - 1")
        if int(seed) < 2 ** 32:
            return np.array([seed], dtype=np.uint32), True
        # large ints fall back to array seeding like numpy
        v, out = int(seed), []
        while v > 0:
            out.append(v & 0xFFFFFFFF)
            v >>= 32
        return np.array(out, dtype=np.uint32), False
    return np.asarray(list(seed), dtype=np.uint32), False


def vdkt_mask_native(nkx: int, nky: int, nphases: int,
                     accelerations: Sequence[float],
                     sim_partial_kx: float, sim_partial_ky: float,
                     seed) -> Optional[np.ndarray]:
    """`VDktMaskFunc.__call__` on the native path; None where the Python
    path is taken. Returns float32 [nphases, nky, nkx]."""
    lib = get_vdkt_lib()
    if lib is None:
        return None
    key, scalar = _seed_key(seed)
    out = np.empty((nphases, nky, nkx), np.float32)
    accel = lib.vdkt_mask(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nkx, nky, nphases,
        float(accelerations[0]), float(accelerations[1]),
        float(sim_partial_kx), float(sim_partial_ky),
        key.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(key),
        int(scalar),
    )
    if accel < 0:
        # the grid-fitting edge walk left [0, ny) past the one-step numpy
        # wrap: the Python path raises IndexError on the same inputs
        raise IndexError(
            f"vdkt edge walk out of bounds (nky={nky}, nphases={nphases})")
    return out
