"""The port's host-side leftovers against the JAX package: the native VDkt
mask (`ops/native.py`) bit for bit against the port's Python path and the
JAX package's VDkt, and its build rules; GCC coil compression
(`data/coilcomp.py`) bit for bit; `ops/utils.py` on tensors against JAX
`ops/utils.py`; `utils/folder_param.py` string for string."""

import numpy as np
import pytest
import torch

import dl_swin_gan_tpu.ops.native as jax_native
from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.data import coilcomp as jax_coilcomp
from dl_swin_gan_tpu.ops import utils as jax_utils
from dl_swin_gan_tpu.ops.masks import VDktMaskFunc as JaxVDkt
from dl_swin_gan_tpu.utils import folder_param as jax_folder
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.data import coilcomp
from dl_swin_gan_tpu_torch.ops import masks, native
from dl_swin_gan_tpu_torch.ops import utils as U
from dl_swin_gan_tpu_torch.utils import folder_param

torch.set_num_threads(1)

# tests/test_masks.py's three native cases, then the 12x serving mask of
# the 20x180x64 headline slice at the parity seed
VDKT_CASES = [
    ((1, 1, 18, 80, 64), (10, 15), 0.25, 0.0, 1000),
    ((1, 1, 18, 80, 64), (10, 15), 0.25, 0.0,
     tuple(map(ord, "patient_003.h5"))),
    ((1, 1, 12, 80, 32), (10, 15), 0.25, 0.25, 5),
    ((1, 1, 20, 180, 64), (12, 12), 0.25, 0.0, 1000),
]


@pytest.fixture
def python_path(monkeypatch):
    """A VDkt call on the Python path: the native hook returns None."""
    def call(func, shape, seed):
        with monkeypatch.context() as m:
            m.setattr(masks, "vdkt_mask_native", lambda *a: None)
            return func(shape, seed=seed)
    return call


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """ops/native.py with nothing loaded and its build root under tmp; the
    process's cached library is dropped again afterwards."""
    native._load.cache_clear()
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.delenv("DL_SWIN_GAN_NO_NATIVE", raising=False)
    yield native
    native._load.cache_clear()


@pytest.mark.parametrize("case", VDKT_CASES,
                         ids=["18x80x64", "name_seed", "partial_ky",
                              "serving_20x180x64"])
def test_native_vdkt_bit_for_bit(case, python_path, monkeypatch):
    """The native mask equals the port's Python path and the JAX package's
    VDkt (its native path and its Python path) bit for bit."""
    shape, accel, pkx, pky, seed = case
    assert native.get_vdkt_lib() is not None, "no C compiler on the path"
    func = masks.VDktMaskFunc(accel, sim_partial_kx=pkx, sim_partial_ky=pky)
    nat = func(shape, seed=seed)
    raw = native.vdkt_mask_native(shape[4], shape[3], shape[2], accel, pkx,
                                  pky, seed)
    np.testing.assert_array_equal(raw.reshape(shape), nat)
    py = python_path(func, shape, seed)
    assert nat.dtype == py.dtype == np.float32 and nat.shape == py.shape
    np.testing.assert_array_equal(nat, py)
    jax_func = JaxVDkt(list(accel), sim_partial_kx=pkx, sim_partial_ky=pky)
    np.testing.assert_array_equal(nat, jax_func(shape, seed=seed))
    monkeypatch.setattr(jax_native, "vdkt_mask_native", lambda *a: None)
    np.testing.assert_array_equal(nat, jax_func(shape, seed=seed))


def test_native_vdkt_errors(python_path):
    """A negative seed raises ValueError; an edge walk that leaves the grid
    raises IndexError on both paths (6 rows at 1x to 1.5x, seed 13)."""
    with pytest.raises(ValueError, match="Seed"):
        native.vdkt_mask_native(8, 32, 4, [10, 15], 0.0, 0.0, -5)
    with pytest.raises(IndexError):
        native.vdkt_mask_native(4, 6, 6, [1.0, 1.5], 0.25, 0.25, 13)
    func = masks.VDktMaskFunc([1.0, 1.5], 0.25, 0.25)
    with pytest.raises(IndexError):
        python_path(func, (1, 1, 6, 6, 4), 13)


def test_native_build_rules(fresh_native, monkeypatch, tmp_path, caplog):
    """The build is keyed by the source under the port's build root; no C
    compiler takes the Python path with a warning; DL_SWIN_GAN_NO_NATIVE=1
    takes it silently; a failed build raises, and so does a library that
    does not load."""
    N = fresh_native
    lib = N.get_vdkt_lib()
    path = N.library_path()
    assert lib is not None and path.exists()
    assert path.parent.parent == tmp_path / "_build"
    assert path.parent.name.startswith("vdkt-")

    monkeypatch.setenv("DL_SWIN_GAN_NO_NATIVE", "1")
    assert N.get_vdkt_lib() is None
    assert N.vdkt_mask_native(8, 32, 4, [10, 15], 0.25, 0.0, 1) is None
    monkeypatch.delenv("DL_SWIN_GAN_NO_NATIVE")
    assert N.get_vdkt_lib() is lib

    N._load.cache_clear()
    monkeypatch.setattr(N, "BUILD_ROOT", tmp_path / "none")
    with monkeypatch.context() as m:
        m.setattr(N.shutil, "which", lambda name: None)
        with caplog.at_level("WARNING", logger=N.__name__):
            assert N.get_vdkt_lib() is None
    assert "no C compiler" in caplog.text

    N._load.cache_clear()
    bad = tmp_path / "bad.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(N, "SRC", bad)
    monkeypatch.setattr(N, "BUILD_ROOT", tmp_path / "bad")
    with pytest.raises(RuntimeError, match="failed"):
        N.get_vdkt_lib()
    good = tmp_path / "good.c"
    good.write_text("int x;\n")
    monkeypatch.setattr(N, "SRC", good)
    N.library_path().parent.mkdir(parents=True)
    N.library_path().write_bytes(b"not a shared library")
    with pytest.raises(OSError):
        N.get_vdkt_lib()


def _coils(seed=0, Y=32, X=24, C=8, T=None):
    """Smooth coil k-space [C, (T,) Y, X] (tests/test_infra.py's)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:Y, 0:X]
    img = np.exp(-(((yy - 16) / 16) ** 2 + ((xx - 12) / 12) ** 2))
    coils = np.stack([img * np.exp(-((yy - 4 * c) ** 2) / 400 + 1j * 0.1 * c)
                      for c in range(C)])
    if T is not None:
        coils = coils[:, None] * (1 + 0.1 * rng.randn(1, T, 1, 1))
    ksp = np.fft.fftshift(np.fft.fft2(coils, norm="ortho"), axes=(-2, -1))
    return ksp.astype(np.complex64)


@pytest.mark.parametrize("T", [None, 3])
def test_coilcomp_bit_for_bit(T):
    ksp = _coils(T=T)
    for nv in (8, 4):
        a = coilcomp.compress(ksp, num_virtual=nv)
        b = jax_coilcomp.compress(ksp, num_virtual=nv)
        assert a.dtype == b.dtype == np.complex64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    calib = np.transpose(ksp.reshape((8, -1) + ksp.shape[-2:])[:, 0],
                         (2, 1, 0))
    for align in (True, False):
        mats = coilcomp.gcc_matrices(calib, 4, align=align)
        np.testing.assert_array_equal(
            mats, jax_coilcomp.gcc_matrices(calib, 4, align=align))
    ksp4 = ksp if ksp.ndim == 4 else ksp[:, None]
    np.testing.assert_array_equal(coilcomp.apply_gcc(ksp4, mats),
                                  jax_coilcomp.apply_gcc(ksp4, mats))


def test_ops_utils_against_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 3, 7, 10, 6) + 1j * rng.randn(2, 3, 7, 10, 6)
         ).astype(np.complex64)
    x[:, :, :, ::3] = 0                       # unacquired rows
    t = torch.from_numpy(x)

    def close(a, b, tol=1e-6):
        a = a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)

    close(U.root_sum_of_squares(t, 1), jax_utils.root_sum_of_squares(x, 1))
    close(U.get_mask(t), jax_utils.get_mask(x))
    for keep in (True, False):
        close(U.time_average(t, 2, keepdim=keep),
              jax_utils.time_average(x, 2, keepdims=keep))
    for window in (1, 5, 7):
        close(U.sliding_window(t, 2, window),
              jax_utils.sliding_window(x, 2, window))
    close(U.center_crop(t, (5, 4), (3, -1)),
          jax_utils.center_crop(x, (5, 4), (3, -1)), 0)
    close(U.center_pad(t, (13, 9), (3, -1)),
          jax_utils.center_pad(x, (13, 9), (3, -1)), 0)
    close(U.center_pad(t.real.contiguous(), (8, 11), (2, 3)),
          jax_utils.center_pad(x.real, (8, 11), (2, 3)), 0)


def _folder_cfgs(get):
    """tests/test_infra.py:144's configs, and every model token."""
    cfgs = []
    for model, depth_key, depth in (("RES", None, None), ("SE", None, None),
                                    ("SWIN", "NUM_SWINBLOCKS", 6),
                                    ("CBAM", "NUM_RESBLOCKS", 3),
                                    ("DIT", "NUM_LAYERS", 12),
                                    ("LATTE", "NUM_LAYERS", 8),
                                    ("UNKNOWN", None, None)):
        cfg = get()
        cfg.MODEL.MODEL_TYPE = model
        if depth_key:
            cfg.MODEL.PARAMETERS[depth_key] = depth
        cfg.MODEL.RECON_LOSS.LOSS_WEIGHT = 1.0 if model == "SE" else 0.0
        cfgs.append(cfg)
    return cfgs


def test_folder_param_equals_jax():
    names = []
    for ours, ref in zip(_folder_cfgs(get_cfg), _folder_cfgs(jax_get_cfg)):
        name = folder_param.parameter_to_folder(ours)
        assert name == jax_folder.parameter_to_folder(ref)
        names.append(name)
        assert (folder_param.folder_to_parameter(name)
                == jax_folder.folder_to_parameter(name))
        a, b = get_cfg(), jax_get_cfg()
        folder_param.folder_to_parameter(name, write_config=True, config=a)
        jax_folder.folder_to_parameter(name, write_config=True, config=b)
        assert a.MODEL.MODEL_TYPE == b.MODEL.MODEL_TYPE
        assert dict(a.MODEL.PARAMETERS) == dict(b.MODEL.PARAMETERS)
        assert a.MODEL.RECON_LOSS.LOSS_WEIGHT == b.MODEL.RECON_LOSS.LOSS_WEIGHT
    assert names[1] == "train-3D_5steps_2SEblocks_256features_2emaps_1weight"
    assert "6SWINblocks" in names[2]
