"""Host-side numpy path of the torch port against the JAX package: VDkt
masks, synthetic slices, inference transforms, CFL and YAML configs must be
bit-identical (the port keeps its own copies of these numpy modules)."""

import glob
import os

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.data import cfl as jax_cfl
from dl_swin_gan_tpu.data.synthetic import make_cine_example as jax_make_cine
from dl_swin_gan_tpu.infer.transforms import (
    InferenceTransform as JaxInferenceTransform,
    ResampleTransform as JaxResampleTransform,
)
from dl_swin_gan_tpu.ops import masks as jax_masks
from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.data import cfl
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer.transforms import (
    PARITY_SEED, InferenceTransform, ResampleTransform,
)
from dl_swin_gan_tpu_torch.ops import masks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))


@pytest.mark.parametrize("shape,accel,partial_ky", [
    ((1, 1, 20, 180, 64), 12.0, 0.0),
    ((1, 1, 20, 180, 64), 12.0, 0.25),
    ((1, 1, 8, 48, 16), 8.0, 0.0),
    ((1, 1, 6, 24, 16), 3.0, 0.25),
])
def test_vdkt_mask_bit_identical(shape, accel, partial_ky):
    ours = masks.VDktMaskFunc((accel, accel), sim_partial_kx=0.25,
                              sim_partial_ky=partial_ky)(shape, PARITY_SEED)
    ref = jax_masks.VDktMaskFunc((accel, accel), sim_partial_kx=0.25,
                                 sim_partial_ky=partial_ky)(shape, PARITY_SEED)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_subsample_matches(rng):
    data = (rng.standard_normal((1, 3, 6, 24, 16))
            + 1j * rng.standard_normal((1, 3, 6, 24, 16))).astype(np.complex64)
    fn = masks.VDktMaskFunc((4.0, 4.0))
    ours = masks.subsample(data, fn, seed=7, mode="3D")
    ref = jax_masks.subsample(data, jax_masks.VDktMaskFunc((4.0, 4.0)),
                              seed=7, mode="3D")
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (3, 0.01)])
def test_make_cine_example_identical(seed, noise):
    ours = make_cine_example(T=6, Y=24, X=16, C=3, E=2, seed=seed, noise=noise)
    ref = jax_make_cine(T=6, Y=24, X=16, C=3, E=2, seed=seed, noise=noise)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_examples_equal(ours, ref):
    assert set(ours) == set(ref) == {"kspace", "mask", "maps",
                                     "init_image", "scale"}
    for key in ref:
        assert np.asarray(ours[key]).dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("slwin", [True, False])
def test_resample_transform_identical(slwin):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.MODEL.PARAMETERS.SLWIN_INIT = slwin
    kspace, maps, _ = make_cine_example(T=8, Y=48, X=16, C=4, E=2, seed=1)
    ours = ResampleTransform(12, cfg)(kspace, maps)
    ref = JaxResampleTransform(12, jcfg)(kspace, maps)
    _assert_examples_equal(ours, ref)


def test_inference_transform_identical():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    kspace, maps, _ = make_cine_example(T=6, Y=24, X=16, C=3, E=2, seed=2)
    kspace = kspace * (np.arange(24)[:, None] % 3 == 0)  # undersampled
    ours = InferenceTransform(cfg, apply_fftmod=True)(kspace, maps)
    ref = JaxInferenceTransform(jcfg, apply_fftmod=True)(kspace, maps)
    _assert_examples_equal(ours, ref)


@pytest.mark.parametrize("order", ["C", "F"])
def test_cfl_interchange(tmp_path, rng, order):
    arr = (rng.standard_normal((3, 4, 5))
           + 1j * rng.standard_normal((3, 4, 5))).astype(np.complex64)
    cfl.write(str(tmp_path / "a"), arr, order=order)
    np.testing.assert_array_equal(jax_cfl.read(str(tmp_path / "a"), order), arr)
    jax_cfl.write(str(tmp_path / "b"), arr, order=order)
    np.testing.assert_array_equal(cfl.read(str(tmp_path / "b"), order), arr)


def _plain(node):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in node.items()}


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_yaml_config_loads_identically(path):
    ours = _plain(load_cfg(path, require_output_dir=False))
    ref = _plain(jax_load_cfg(path, require_output_dir=False))
    # the one default that differs by design: the device the package runs on
    assert ours["MODEL"].pop("DEVICE") == "cuda"
    ref["MODEL"].pop("DEVICE")
    assert ours == ref


def test_config_rejects_unknown_and_frozen():
    cfg = get_cfg()
    with pytest.raises(KeyError):
        cfg.merge_from_list(["MODEL.PARAMETERS.NUM_UNROLLZ", 3])
    cfg.merge_from_list(["MODEL.PARAMETERS.NUM_UNROLLS", "3"])
    assert cfg.MODEL.PARAMETERS.NUM_UNROLLS == 3
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.MODEL.PARAMETERS.NUM_UNROLLS = 4
