"""End-to-end reconstruction of the torch port against the JAX package, the
device rule of its entry points, and its independence from JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.data import cfl as jax_cfl
from dl_swin_gan_tpu.infer.reconstruct import Reconstructor as JaxReconstructor
from dl_swin_gan_tpu.infer.reconstruct import reconstruct_h5_file as jax_recon_h5
from dl_swin_gan_tpu.infer.transforms import ResampleTransform as JaxResample
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu.solvers import build_solver as jax_build_solver
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch, init_params
from dl_swin_gan_tpu_torch.data import cfl
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example, write_synthetic_dataset
from dl_swin_gan_tpu_torch.infer import Reconstructor, ResampleTransform, reconstruct_h5_file
from dl_swin_gan_tpu_torch.infer.reconstruct import batched

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
T, Y, X, C, E = 8, 48, 16, 4, 2
ACCEL = 12


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


@pytest.fixture(scope="module")
def jax_model():
    """(JAX cfg, flax params) of a tiny RES/pgd solver."""
    jcfg = _cfg(jax_get_cfg())
    model = jax_build_solver(jcfg, lambda: jax_build_denoiser(jcfg))
    kspace, maps, _ = make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=0)
    ex = JaxResample(ACCEL, jcfg)(kspace, maps)
    b = {k: np.asarray(v)[None] for k, v in ex.items()}
    init = jax.jit(lambda k, m, s, x0: model.init(
        jax.random.PRNGKey(0), k, m, s, x0=x0)["params"])
    params = init(b["kspace"], b["maps"], b["mask"], b["init_image"])
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def test_reconstructor_matches_jax(jax_model):
    jcfg, params = jax_model
    cfg = _cfg(get_cfg())
    examples = [ResampleTransform(ACCEL, cfg)(
        *make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=s)[:2])
        for s in (0, 1)]
    batch = next(batched(examples, 2))
    ref = JaxReconstructor(jcfg, params)(batch)
    out = Reconstructor(cfg, flax_to_torch(params), device="cpu")(batch)
    assert out.shape == ref.shape == (2, E, T, Y, X)
    assert out.dtype == np.complex64 and np.isfinite(out).all()
    assert _rel_l2(out, ref) <= 1e-4


def test_reconstruct_h5_file_matches_jax(jax_model, tmp_path):
    pytest.importorskip("h5py")
    jcfg, params = jax_model
    cfg = _cfg(get_cfg())
    (path,) = write_synthetic_dataset(str(tmp_path / "data"), num_files=1,
                                      slices=2, T=T, Y=Y, X=X, C=C, E=E)
    ours = reconstruct_h5_file(path, str(tmp_path / "ours"), cfg,
                               flax_to_torch(params), acceleration=ACCEL,
                               batch_size=2, device="cpu")
    ref = jax_recon_h5(path, str(tmp_path / "ref"), jcfg, params,
                       acceleration=ACCEL, batch_size=2)
    assert os.path.basename(ours) == os.path.basename(ref)
    a, b = cfl.read(ours, order="F"), jax_cfl.read(ref, order="F")
    assert a.shape == b.shape == (X, Y, 2, E, T, 1, 1, 1)
    assert _rel_l2(a, b) <= 1e-4


def test_reconstructor_needs_cuda_or_explicit_cpu(monkeypatch):
    cfg = _cfg(get_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Reconstructor(cfg, init_params(cfg, 0))
    assert Reconstructor(cfg, init_params(cfg, 0), device="cpu").device.type == "cpu"


def _port_files():
    return sorted((REPO / "dl_swin_gan_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "compare_attn_bwd.py",
        REPO / "compare_attn_fwd.py", REPO / "compare_attn_bf16.py",
        REPO / "compare_coil_normal.py"]


# the DSLR serving, pgd and RNN modules, named so that the walk must reach
# them
_DSLR_MODULES = ("dl_swin_gan_tpu_torch.ops.threefry",
                 "dl_swin_gan_tpu_torch.models.rnn",
                 "dl_swin_gan_tpu_torch.scripts.reconstruct_lr")
# the last modules ported: the host leftovers, compact serving and the
# root scripts' entry points
_LAST_MODULES = ("dl_swin_gan_tpu_torch.ops.native",
                 "dl_swin_gan_tpu_torch.ops.utils",
                 "dl_swin_gan_tpu_torch.data.coilcomp",
                 "dl_swin_gan_tpu_torch.utils.folder_param",
                 "dl_swin_gan_tpu_torch.infer.compact",
                 "dl_swin_gan_tpu_torch.scripts.batch_recon",
                 "dl_swin_gan_tpu_torch.scripts.eval",
                 "dl_swin_gan_tpu_torch.scripts.eval_recon",
                 "dl_swin_gan_tpu_torch.scripts.display_data",
                 "dl_swin_gan_tpu_torch.scripts.write_dcm")


def test_port_imports_no_jax_subprocess():
    """Importing every port module, chip_smoke and the compare scripts pulls in
    no jax, flax or JAX-package module (run with the repo alone on the path,
    so no site customisation that imports jax is inherited)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dl_swin_gan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, compare_attn_bwd, compare_attn_fwd, "
        "compare_attn_bf16, compare_coil_normal\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dl_swin_gan_tpu')]\n"
        "bad += [m for m in NEW if m not in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
        "sys.exit(1 if bad else 0)\n").replace(
        "NEW", repr(_DSLR_MODULES + _LAST_MODULES))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip()) >= 20   # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|dl_swin_gan_tpu)\b"
    r"|import_module\(\s*['\"](jax|jaxlib|flax|dl_swin_gan_tpu)\b"
    r"|__import__\(\s*['\"](jax|jaxlib|flax|dl_swin_gan_tpu)\b",
    re.MULTILINE)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    assert not _FORBIDDEN.search(path.read_text()), path
