"""FFT and SENSE operators of the torch port against the JAX package, and the
SENSE-normal kernel's plain version against the Pallas TPU kernel (run in
interpret mode on the CPU, as tests/test_sense_kernel.py runs it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl_swin_gan_tpu.kernels.sense_normal as SN
from dl_swin_gan_tpu.ops import fft as jfft
from dl_swin_gan_tpu.ops import sense as jsense
from dl_swin_gan_tpu_torch.kernels import sense_normal as K
from dl_swin_gan_tpu_torch.ops import fft, sense

torch.set_num_threads(1)

# fp32 DFT-by-matmul against an FFT: the JAX kernel test's own tolerances
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = SN.pl.pallas_call
    monkeypatch.setattr(SN.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))


def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _data(rng, B=2, E=2, C=4, T=3, Y=12, X=10, per_coil_mask=False):
    x = _c64(rng, B, E, T, Y, X)
    maps = _c64(rng, B, E, C, 1, Y, X)
    mask = (rng.rand(B, C if per_coil_mask else 1, T, Y, X) < 0.4
            ).astype(np.float32)
    return x, maps, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("centered", [False, True])
def test_fft_matches_jax(rng, centered):
    a = _c64(rng, 2, 3, 12, 10)
    np.testing.assert_allclose(fft.fftc(_t(a), centered=centered).numpy(),
                               np.asarray(jfft.fftc(a, centered=centered)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fft.ifftc(_t(a), centered=centered).numpy(),
                               np.asarray(jfft.ifftc(a, centered=centered)),
                               rtol=1e-5, atol=1e-5)


def test_fftmod_matches_jax(rng):
    a = _c64(rng, 2, 7, 10)
    np.testing.assert_array_equal(fft.fftmod(_t(a)).numpy(),
                                  np.asarray(jfft.fftmod(a)))


@pytest.mark.parametrize("with_mask", [True, False])
def test_forward_adjoint_match_jax(rng, with_mask):
    x, maps, mask = _data(rng)
    mask = mask if with_mask else None
    tmask = None if mask is None else _t(mask)
    y = sense.sense_forward(_t(x), _t(maps), tmask)
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(jsense.sense_forward(x, maps, mask)),
                               rtol=1e-5, atol=1e-5)
    back = sense.sense_adjoint(y, _t(maps), tmask)
    ref = jsense.sense_adjoint(np.asarray(y.numpy()), maps, mask)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_ortho_dft_matches_tpu_kernel_tables():
    for n in (7, 12, 180):
        fr, fi = SN._ortho_dft(n)
        ours = K.ortho_dft(n, torch.device("cpu")).numpy()
        np.testing.assert_array_equal(ours.real, fr)
        np.testing.assert_array_equal(ours.imag, fi)


def _kernel_inputs(x, maps, mask):
    B, E, T, Y, X = x.shape
    m = maps[:, :, :, 0]
    if mask is None:
        w = np.ones((B, T, Y, X), np.float32)
    else:
        w = np.broadcast_to(mask[:, 0], (B, T, Y, X)) ** 2
    return x, np.ascontiguousarray(m), np.ascontiguousarray(w, np.float32)


@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_matches_pallas_kernel(rng, interpret_mode, with_mask):
    x, maps, mask = _data(rng, B=2 if with_mask else 1)
    x, m, w = _kernel_inputs(x, maps, mask if with_mask else None)
    outr, outi = SN.sense_normal_fused(x.real, x.imag, m.real, m.imag, w)
    ref = np.asarray(outr) + 1j * np.asarray(outi)
    ours = K.sense_normal_plain(_t(x), _t(m), _t(w)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_mask", [True, False])
def test_normal_matches_jax_chain(rng, with_mask):
    x, maps, mask = _data(rng)
    mask = mask if with_mask else None
    ref = jsense._adjoint_impl(jsense._forward_impl(x, maps, mask), maps, mask)
    ours = sense.sense_normal(_t(x), _t(maps),
                              None if mask is None else _t(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_per_coil_mask_takes_fft_chain(rng, monkeypatch):
    """Per-coil masks are not fusable (the JAX dispatch rule): the wrapper is
    not called, and the FFT chain matches the JAX chain."""
    x, maps, mask = _data(rng, per_coil_mask=True)

    def boom(*a):
        raise AssertionError("kernel wrapper called for a per-coil mask")

    monkeypatch.setattr(K, "sense_normal", boom)
    ours = sense.sense_normal(_t(x), _t(maps), _t(mask))
    ref = jsense._adjoint_impl(jsense._forward_impl(x, maps, mask), maps, mask)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_normal_routes_fusable_shapes_through_wrapper(rng, monkeypatch):
    x, maps, mask = _data(rng)
    calls = []
    orig = K.sense_normal

    def spy(*a):
        calls.append([t.shape for t in a])
        return orig(*a)

    monkeypatch.setattr(K, "sense_normal", spy)
    before = orig.launches
    sense.sense_normal(_t(x), _t(maps), _t(mask))
    B, E, T, Y, X = x.shape
    C = maps.shape[2]
    assert calls == [[(B, E, T, Y, X), (B, E, C, Y, X), (B, T, Y, X)]]
    assert orig.launches == before  # the CPU runs the plain version


def test_normal_gradient_matches_jax(rng):
    """Gradient of sum |N(x)|^2 through the autograd.Function. PyTorch
    reports the conjugate of jax.grad's complex gradient."""
    x, maps, mask = _data(rng, B=1, E=2, C=3, T=2, Y=10, X=8)

    def loss(v):
        return jnp.sum(jnp.abs(jsense.sense_normal(v, maps, mask)) ** 2)

    g_ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (sense.sense_normal(xt, _t(maps), _t(mask)).abs() ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.conj(g_ref),
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("bad", ["dtype", "wshape", "mapshape", "ndim"])
def test_wrapper_rejects_what_the_kernel_cannot_take(rng, bad):
    x, maps, mask = _data(rng)
    x, m, w = (_t(a) for a in _kernel_inputs(x, maps, mask))
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "wshape":
        w = w[:, :1]
    elif bad == "mapshape":
        m = m[..., :-1]
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        K.sense_normal(x, m, w)
