"""CFL serving, the deployment path: the port's `reconstruct_cfl` against the
JAX package's on converted weights, at a toy geometry with 2 slices and 2
echoes (where a slice/echo mix-up would show), and the port's reconstruct
command lines against the library calls they wrap.

Tolerance: rel L2 1e-5. Both packages run the same numpy transforms and a
float32 solver (sums in other orders)."""

import os

import jax
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.data import cfl as jax_cfl
from dl_swin_gan_tpu.infer.reconstruct import reconstruct_cfl as jax_reconstruct_cfl
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu.solvers import build_solver as jax_build_solver
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data import cfl
from dl_swin_gan_tpu_torch.data.host_ops import fftmod
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer import reconstruct_cfl, reconstruct_h5_file
from dl_swin_gan_tpu_torch.infer.transforms import InferenceTransform
from dl_swin_gan_tpu_torch.ops.masks import VDktMaskFunc
from dl_swin_gan_tpu_torch.scripts import reconstruct, reconstruct_h5
from dl_swin_gan_tpu_torch.train import CheckpointManager, Trainer

torch.set_num_threads(1)

T, Y, X, C, E = 6, 40, 16, 4, 2
SLICES, ECHOES = 2, 2
TOL = 1e-5


def _cfg(cfg):
    p = cfg.MODEL.PARAMETERS
    cfg.MODEL.MODEL_TYPE = "RES"
    p.NUM_UNROLLS = 2
    p.NUM_RESBLOCKS = 1
    p.NUM_FEATURES = 8
    p.NUM_EMAPS = E
    p.FIX_STEP_SIZE = True
    p.SLWIN_INIT = True
    p.CONV_BLOCK.COMPLEX = False
    cfg.OUTPUT_DIR = "runs/test"
    return cfg


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _scanner_arrays():
    """Undersampled scanner k-space [x, y, slice, coil, 1, echo, 1, phase]
    (not fftmod'ed) and maps [x, y, slice, coil, emap]; every (slice, echo)
    a different phantom."""
    mask = VDktMaskFunc((4, 4))((1, 1, T, Y, X), 7)[0]          # [1, T, Y, X]
    ks = np.zeros((X, Y, SLICES, C, 1, ECHOES, 1, T), np.complex64)
    maps = np.zeros((X, Y, SLICES, C, E), np.complex64)
    for sl in range(SLICES):
        for ec in range(ECHOES):
            k, m, _ = make_cine_example(T=T, Y=Y, X=X, C=C, E=E,
                                        seed=10 * sl + ec)
            ks[:, :, sl, :, 0, ec, 0, :] = np.transpose(
                fftmod(k * mask), (3, 2, 0, 1))
        maps[:, :, sl] = np.transpose(fftmod(m[:, :, 0]), (3, 2, 1, 0))
    return ks, maps


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """(directory with ks/maps CFLs, JAX cfg, flax params)."""
    d = tmp_path_factory.mktemp("cfl")
    ks, maps = _scanner_arrays()
    cfl.write(str(d / "ks"), ks, order="F")
    cfl.write(str(d / "maps"), maps, order="F")
    jcfg = _cfg(jax_get_cfg())
    model = jax_build_solver(jcfg, lambda: jax_build_denoiser(jcfg))
    ex = InferenceTransform(jcfg, apply_fftmod=True)(
        np.transpose(ks[:, :, 0, :, 0, 0, 0, :], (2, 3, 1, 0)),
        np.transpose(maps[:, :, 0], (3, 2, 1, 0))[:, :, None])
    b = {k: np.asarray(v)[None] for k, v in ex.items()}
    params = jax.jit(lambda k, m, s, x0: model.init(
        jax.random.PRNGKey(0), k, m, s, x0=x0)["params"])(
        b["kspace"], b["maps"], b["mask"], b["init_image"])
    return d, jcfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_reconstruct_cfl_matches_jax(setting, batch_size):
    d, jcfg, params = setting
    ours = reconstruct_cfl(str(d / "ks"), str(d / "maps"),
                           str(d / f"ours{batch_size}"), _cfg(get_cfg()),
                           flax_to_torch(params), batch_size=batch_size,
                           device="cpu")
    ref = jax_reconstruct_cfl(str(d / "ks"), str(d / "maps"),
                              str(d / f"ref{batch_size}"), jcfg, params,
                              batch_size=batch_size)
    a, b = cfl.read(ours, order="F"), jax_cfl.read(ref, order="F")
    assert a.shape == b.shape == (X, Y, SLICES, 1, E, ECHOES, 1, T)
    assert a.dtype == np.complex64 and np.isfinite(a).all()
    assert _rel_l2(a, b) <= TOL
    # every (slice, echo) lands where the JAX package puts it
    for sl in range(SLICES):
        for ec in range(ECHOES):
            assert _rel_l2(a[:, :, sl, :, :, ec], b[:, :, sl, :, :, ec]) <= TOL


def test_reconstruct_cfl_needs_cuda_or_explicit_cpu(setting, monkeypatch):
    d, _, params = setting
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reconstruct_cfl(str(d / "ks"), str(d / "maps"), str(d / "nope"),
                        _cfg(get_cfg()), flax_to_torch(params))


def _checkpoint(directory, cfg, params):
    """A checkpoint of the port's trainer holding `params`."""
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(state_dict=params)
    CheckpointManager(str(directory)).save(0, state)
    return str(directory)


def test_command_lines_match_library_calls(setting, tmp_path):
    """scripts/reconstruct.py and scripts/reconstruct_h5.py on a YAML and a
    checkpoint give the files of reconstruct_cfl and reconstruct_h5_file."""
    pytest.importorskip("yaml")
    h5py = pytest.importorskip("h5py")
    d, _, jparams = setting
    cfg = _cfg(get_cfg())
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(cfg.dump())
    params = flax_to_torch(jparams)
    ckpt = _checkpoint(tmp_path / "ckpt", cfg, params)

    out = reconstruct.main([
        "--config-file", str(cfg_path), "--ckpt", ckpt, "--kspace",
        str(d / "ks"), "--maps", str(d / "maps"), "--output",
        str(tmp_path / "cli"), "--device", "cpu"])
    ref = reconstruct_cfl(str(d / "ks"), str(d / "maps"), str(tmp_path / "lib"),
                          cfg, params, device="cpu")
    assert np.array_equal(cfl.read(out, order="F"), cfl.read(ref, order="F"))

    h5 = tmp_path / "exam.h5"
    k, m, t = make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=3)
    with h5py.File(h5, "w") as f:
        f["kspace"], f["maps"], f["target"] = k[None], m[None], t[None]
    for accel in ("1", "12"):
        out = reconstruct_h5.main([
            "--config-file", str(cfg_path), "--ckpt", ckpt, "--file", str(h5),
            "--out-directory", str(tmp_path / "cli_h5"), "--acceleration",
            accel, "--device", "cpu"])
        ref = reconstruct_h5_file(str(h5), str(tmp_path / "lib_h5"), cfg,
                                  params, acceleration=float(accel),
                                  device="cpu")
        assert os.path.basename(out) == os.path.basename(ref) == \
            f"exam_{accel}accel.im"
        assert np.array_equal(cfl.read(out, order="F"),
                              cfl.read(ref, order="F"))
