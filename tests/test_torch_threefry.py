"""The port's numpy Threefry draw (`ops/threefry.py`) against
`jax.random.uniform` bit for bit, and `ops/cg.power_method` against the
JAX package's on the same start vector."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.ops.cg import power_method as jax_power_method
from dl_swin_gan_tpu_torch.ops import threefry
from dl_swin_gan_tpu_torch.ops.cg import power_method

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", (0, 7, 123456789))
@pytest.mark.parametrize("shape", ((207, 8, 1), (3, 3, 1), (5,), (7, 11, 13)))
def test_uniform_matches_jax_bit_for_bit(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = threefry.uniform(seed, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_prng_key_and_bits_match_jax():
    key = jax.random.PRNGKey(42)
    assert np.array_equal(threefry.prng_key(42),
                          np.asarray(jax.random.key_data(key)))
    want = np.asarray(jax.random.bits(key, (4, 6), jnp.uint32))
    assert np.array_equal(threefry.random_bits(threefry.prng_key(42), (4, 6)),
                          want)
    with pytest.raises(ValueError):
        threefry.prng_key(-1)


def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", ((5, 48, 3), (4, 6, 3)))
def test_power_method_matches_jax(shape):
    """Output and the gradient of a loss of it in A, against the JAX
    function on the same start vector (PRNGKey(0)'s), to 1e-5."""
    A = _c64(np.random.RandomState(0), *shape)
    b, _, n = shape
    key = jax.random.PRNGKey(0)
    jf = lambda a: jax_power_method(a, 10, key)      # noqa: E731
    want = np.asarray(jf(jnp.asarray(A)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jf(a) ** 2))(
        jnp.asarray(A)))
    v0 = torch.from_numpy(threefry.uniform(0, (b, n, 1))).to(torch.complex64)
    At = torch.from_numpy(A).requires_grad_(True)
    ev = power_method(At, 10, v0)
    (ev ** 2).sum().backward()
    assert ev.shape == (b,)
    np.testing.assert_allclose(ev.detach().numpy(), want, rtol=1e-5)
    # JAX's gradient in a complex input is the conjugate of torch's
    g = At.grad.numpy()
    assert (np.linalg.norm(g - np.conj(jgrad))
            <= 1e-5 * np.linalg.norm(jgrad))
