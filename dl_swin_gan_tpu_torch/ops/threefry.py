"""JAX's counter-based random draws, in numpy.

The JAX package's `dslr-pgd` solver starts its power method from
`jax.random.uniform(jax.random.PRNGKey(0), (b, n, 1))`. This module gives
the same float32 values without JAX: Threefry-2x32 (20 rounds, Salmon et
al., SC 2011) keyed by `PRNGKey(seed)` = (0, seed) for a seed of 32 bits,
over the counters JAX uses when `jax_threefry_partitionable` is on (its
default): element i of the row-major output hashes the 64-bit counter i,
split into (hi, lo) words, and its 32 random bits are the two output words
xor-ed. `uniform` then keeps the top 23 bits as a mantissa, ORs in the
exponent of 1.0 (0x3F800000) and subtracts 1, as `jax.random.uniform` does
for float32 in [0, 1).
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def prng_key(seed: int) -> np.ndarray:
    """The two uint32 words of `jax.random.PRNGKey(seed)`, 0 <= seed < 2**32
    (JAX's default 32-bit mode)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"prng_key: seed {seed} outside [0, 2**32)")
    return np.array([0, seed], dtype=np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words (x0, x1) under `key`: the two
    uint32 output words, elementwise."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)` under partitionable threefry."""
    n = int(np.prod(shape, dtype=np.int64))
    counter = np.arange(n, dtype=np.uint64)
    hi = (counter >> np.uint64(32)).astype(np.uint32)
    lo = (counter & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(seed: int, shape) -> np.ndarray:
    """float32 `jax.random.uniform(jax.random.PRNGKey(seed), shape)`."""
    bits = random_bits(prng_key(seed), tuple(shape))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), floats - np.float32(1.0))
