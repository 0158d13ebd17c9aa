"""BART-compatible CFL read/write.

A copy of `data/cfl.py` in the JAX package: a `.hdr` text file with dimension sizes plus a raw complex64 `.cfl` blob. Supports
both the reference's 'C' convention (hdr dims reversed, row-major blob) and
BART's native 'F' convention — byte-compatible with files the reference
reads and writes.
"""

import numpy as np


def read_hdr(name: str, order: str = "C"):
    with open(name + ".hdr") as f:
        f.readline()  # "# Dimensions"
        dims = [int(i) for i in f.readline().split()]
    if order == "C":
        dims.reverse()
    return dims


def read(name: str, order: str = "C") -> np.ndarray:
    """Read `<name>.hdr` + `<name>.cfl` into a numpy complex64 array."""
    dims = read_hdr(name, order)
    n = np.prod(dims)
    with open(name + ".cfl", "rb") as f:
        data = np.fromfile(f, dtype=np.complex64, count=n)
    return data.reshape(dims, order=order)


def write(name: str, array: np.ndarray, order: str = "C") -> None:
    """Write `<name>.hdr` + `<name>.cfl` (complex64)."""
    with open(name + ".hdr", "w") as f:
        f.write("# Dimensions\n")
        shape = array.shape[::-1] if order == "C" else array.shape
        f.write(" ".join(str(i) for i in shape) + "\n")
    with open(name + ".cfl", "wb") as f:
        if order == "C":
            array.astype(np.complex64).tofile(f)
        else:
            array.T.astype(np.complex64).tofile(f)


def readcfl(name: str) -> np.ndarray:
    """BART-native column-major read (reference cfl.py:41-42)."""
    return read(name, order="F")


def writecfl(name: str, array: np.ndarray) -> None:
    """BART-native column-major write (reference cfl.py:66-67)."""
    write(name, array, order="F")
