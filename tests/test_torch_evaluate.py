"""The port's evaluator (`dl_swin_gan_tpu_torch/infer/evaluate.py`) and its
script against the JAX package's, bit for bit: both are numpy and scipy on
the same inputs, so every function must return the same bits (`==`)."""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dl_swin_gan_tpu.data import cfl as jax_cfl
from dl_swin_gan_tpu.infer import evaluate as J
from dl_swin_gan_tpu_torch.data import cfl
from dl_swin_gan_tpu_torch.infer import evaluate as P
from dl_swin_gan_tpu_torch.scripts import evaluate as script

REPO = Path(__file__).resolve().parent.parent


def _pair(rng, shape):
    ref = rng.rand(*shape)
    return ref, ref + 0.1 * rng.standard_normal(shape)


def _volumes(rng, S=2, E=2, T=3, Y=20, X=18):
    def c(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    ref = c(S, E, T, Y, X)
    return ref, (ref + 0.2 * c(S, E, T, Y, X)).astype(np.complex64)


def _assert_same(a, b):
    """The same values to the bit, and the same types."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    assert type(a) is type(b)
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("size,sigma", [(11, 1.5), (7, 1.0), (5, 2.5)])
def test_gaussian_kernel_bit_exact(size, sigma):
    _assert_same(P._gaussian_kernel(size, sigma), J._gaussian_kernel(size, sigma))


@pytest.mark.parametrize("ksize,std", [((5, 5), 2.5), ((8, 8), 4.0),
                                       ((11, 7), 5.5)])
def test_gaussian_window_ref_bit_exact(ksize, std):
    _assert_same(P._gaussian_window_ref(ksize, std),
                 J._gaussian_window_ref(ksize, std))


@pytest.mark.parametrize("data_range,full", [(None, False), (None, True),
                                             (2.0, True)])
def test_ssim2d_bit_exact(data_range, full):
    ref, img = _pair(np.random.RandomState(0), (40, 36))
    _assert_same(P.ssim2d(ref, img, data_range=data_range, full=full),
                 J.ssim2d(ref, img, data_range=data_range, full=full))


@pytest.mark.parametrize("ksize,full", [((5, 5), False), ((8, 8), True),
                                        ((5, 7), True)])
def test_ssim_ref_windowed_bit_exact(ksize, full):
    recon, ref = _pair(np.random.RandomState(1), (30, 26))
    _assert_same(P.ssim_ref_windowed(recon, ref, ksize=ksize, full=full),
                 J.ssim_ref_windowed(recon, ref, ksize=ksize, full=full))


def test_rmse_psnr_bit_exact():
    ref, img = _pair(np.random.RandomState(2), (24, 20))
    _assert_same(P.rmse(ref, img), J.rmse(ref, img))
    _assert_same(P.psnr(ref, img), J.psnr(ref, img))


@pytest.mark.parametrize("with_roi,return_maps", [(False, False),
                                                  (True, False), (True, True)])
def test_evaluate_volumes_bit_exact(with_roi, return_maps):
    rng = np.random.RandomState(3)
    ref, rec = _volumes(rng)
    roi = (rng.rand(20, 18) > 0.3).astype(np.float32) if with_roi else None
    ours = P.evaluate_volumes(ref, rec, roi=roi, return_maps=return_maps)
    _assert_same(ours, J.evaluate_volumes(ref, rec, roi=roi,
                                          return_maps=return_maps))
    if return_maps:
        for key in ("ssim_image", "rmse_image"):
            _assert_same(P.mean_roi(ours[key], roi),
                         J.mean_roi(ours[key], roi))


def _write_im(path, images, module):
    """[slices, E, T, Y, X] -> the scanner-order CFL of reconstruct_h5."""
    images = np.transpose(images, (4, 3, 0, 1, 2))
    module.write(path, images[:, :, :, :, :, None, None, None], order="F")


def test_evaluate_cfl_pair_bit_exact(tmp_path):
    ref, rec = _volumes(np.random.RandomState(4))
    _write_im(str(tmp_path / "exam_1accel.im"), ref, cfl)
    _write_im(str(tmp_path / "exam_12accel.im"), rec, jax_cfl)
    args = (str(tmp_path / "exam_12accel.im"), str(tmp_path / "exam_1accel.im"))
    _assert_same(P.evaluate_cfl_pair(*args), J.evaluate_cfl_pair(*args))


def test_script_csv_matches_jax_script(tmp_path, capsys):
    """Three exams, one without its reference (skipped by both): the same
    columns and rows, to the last digit, and the same mean and std."""
    pytest.importorskip("pandas")
    sys.path.insert(0, str(REPO))
    from scripts.evaluate import main as jax_main

    rng = np.random.RandomState(5)
    for i, name in enumerate(("exam_a", "exam_b", "exam_c")):
        ref, rec = _volumes(rng)
        if i < 2:
            _write_im(str(tmp_path / f"{name}_1accel.im"), ref, cfl)
        _write_im(str(tmp_path / f"{name}_12accel.im"), rec, cfl)
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    assert script.main(["--recon-directory", str(tmp_path), "--acceleration",
                        "12", "--output", str(ours)]) == 0
    printed = capsys.readouterr().out
    assert jax_main(["--recon-directory", str(tmp_path), "--acceleration",
                     "12.0", "--output", str(theirs)]) == 0
    assert ours.read_text() == theirs.read_text()
    rows = list(csv.DictReader(ours.open()))
    assert [r["name"] for r in rows] == ["exam_a", "exam_b"]
    assert list(rows[0]) == ["ssim", "rmse", "psnr", "name"]
    import pandas as pd
    stats = pd.read_csv(theirs).describe().loc[["mean", "std"]]
    for label in ("mean", "std"):
        line = next(ln for ln in printed.splitlines()
                    if ln.startswith(label)).split()[1:]
        np.testing.assert_allclose([float(v) for v in line],
                                   stats.loc[label].to_numpy(), atol=1e-6)


def test_script_default_output_and_nothing_to_evaluate(tmp_path):
    ref, rec = _volumes(np.random.RandomState(6))
    _write_im(str(tmp_path / "x_1accel.im"), ref, cfl)
    _write_im(str(tmp_path / "x_1.5accel.im"), rec, cfl)
    assert script.main(["--recon-directory", str(tmp_path),
                        "--acceleration", "1.5"]) == 0
    assert (tmp_path / "eval_1.5accel.csv").exists()
    assert script.main(["--recon-directory", str(tmp_path),
                        "--acceleration", "12"]) == 1


# ----------------------------------------------------- tests/test_ssim_oracle.py
# its cases that need no reference checkout, on the port's evaluator

def test_ssim2d_matches_independent_window_stack():
    """ssim2d (convolution) vs a sliding-window recomputation of the same
    standard-SSIM definition, on the interior."""
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.RandomState(1)
    n = 48
    ref = rng.rand(n, n)
    img = ref + 0.05 * rng.rand(n, n)
    win, sigma = 11, 1.5
    pad = win // 2
    L = ref.max() - ref.min()
    C1, C2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    k = P._gaussian_kernel(win, sigma)
    w1 = sliding_window_view(ref, (win, win))
    w2 = sliding_window_view(img, (win, win))
    mu1 = (w1 * k).sum(axis=(-2, -1))
    mu2 = (w2 * k).sum(axis=(-2, -1))
    s1 = (w1 ** 2 * k).sum(axis=(-2, -1)) - mu1 ** 2
    s2 = (w2 ** 2 * k).sum(axis=(-2, -1)) - mu2 ** 2
    s12 = (w1 * w2 * k).sum(axis=(-2, -1)) - mu1 * mu2
    expected = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 ** 2 + mu2 ** 2 + C1) * (s1 + s2 + C2))
    _, full_map = P.ssim2d(ref, img, full=True)
    np.testing.assert_allclose(full_map[pad:-pad, pad:-pad], expected,
                               rtol=1e-9, atol=1e-12)


def test_ssim_basic_properties():
    rng = np.random.RandomState(2)
    x = rng.rand(64, 64)
    assert P.ssim2d(x, x) == pytest.approx(1.0)
    assert P.ssim_ref_windowed(x, x, ksize=(5, 5)) == pytest.approx(1.0,
                                                                   abs=1e-9)
    small = P.ssim2d(x, x + 0.05 * rng.rand(64, 64))
    big = P.ssim2d(x, x + 0.5 * rng.rand(64, 64))
    assert 1.0 > small > big


# ---------------------------------------------------------------- imports

def test_new_modules_import_no_jax_subprocess():
    """The evaluator, the bench and every command line of the port import no
    jax, flax or JAX-package module."""
    code = (
        "import sys\n"
        "import dl_swin_gan_tpu_torch.bench\n"
        "import dl_swin_gan_tpu_torch.infer.evaluate\n"
        "import dl_swin_gan_tpu_torch.scripts.evaluate\n"
        "import dl_swin_gan_tpu_torch.scripts.quality_row\n"
        "import dl_swin_gan_tpu_torch.scripts.reconstruct\n"
        "import dl_swin_gan_tpu_torch.scripts.reconstruct_h5\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dl_swin_gan_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
