"""The port's ports of the root evaluation and visualisation scripts
(`dl_swin_gan_tpu_torch/scripts/{batch_recon,eval,eval_recon,display_data,
write_dcm}.py`) against the root scripts that drive the JAX package, on
the tiny recon pair `tests/test_aux_scripts.py` builds."""

import glob
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

from dl_swin_gan_tpu.data import cfl as jax_cfl
from dl_swin_gan_tpu.data.synthetic import write_synthetic_dataset
from dl_swin_gan_tpu_torch.data import cfl
from dl_swin_gan_tpu_torch.scripts import (
    batch_recon, display_data, eval as eval_script, eval_recon, write_dcm,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))


def _root(name):
    """A root script (which runs the JAX package) by its module name."""
    import importlib

    return importlib.import_module(name)


@pytest.fixture(scope="module")
def recon_dir(tmp_path_factory):
    """exam_{1,12}accel.im in scanner dim order, clean and noisy, as
    tests/test_aux_scripts.py makes them."""
    d = tmp_path_factory.mktemp("recon")
    rng = np.random.RandomState(0)
    sl, e, t, y, x = 2, 2, 4, 24, 16
    yy, xx = np.mgrid[0:y, 0:x]
    base = np.exp(-((yy - y / 2) ** 2 + (xx - x / 2) ** 2) / 40.0)
    clean = (base[None, None, None] *
             (1.0 + 0.2 * np.sin(np.arange(t) / t * 2 * np.pi))
             .reshape(1, 1, t, 1, 1)).astype(np.complex64)
    clean = np.broadcast_to(clean, (sl, e, t, y, x)).copy()
    noisy = clean + 0.05 * (rng.randn(*clean.shape) +
                            1j * rng.randn(*clean.shape)).astype(np.complex64)
    for name, vol in (("exam_1accel.im", clean), ("exam_12accel.im", noisy)):
        v = np.transpose(vol, (4, 3, 0, 1, 2))[:, :, :, :, :, None, None, None]
        jax_cfl.write(str(d / name), v, order="F")
    return d


def _eval_pickles(recon_dir, tmp_path, maps=True):
    extra = [] if maps else ["--no-maps"]
    ours, ref = str(tmp_path / "ours.pkl"), str(tmp_path / "ref.pkl")
    eval_script.main(["--recon-directory", str(recon_dir), "--acceleration",
                      "12", "--output", ours] + extra)
    _root("eval").main(["--recon-directory", str(recon_dir),
                        "--acceleration", "12", "--output", ref] + extra)
    with open(ours, "rb") as f, open(ref, "rb") as g:
        return pickle.load(f), pickle.load(g)


@pytest.mark.parametrize("maps", [True, False])
def test_eval_pickle_equals_jax(recon_dir, tmp_path, maps):
    ours, ref = _eval_pickles(recon_dir, tmp_path, maps)
    assert set(ours) == set(ref) == {"exam"}
    assert set(ours["exam"]) == set(ref["exam"])
    assert ("ssim_image" in ours["exam"]) == maps
    for key, value in ours["exam"].items():
        np.testing.assert_array_equal(value, ref["exam"][key], err_msg=key)


def test_eval_recon_equals_jax(recon_dir, tmp_path, capsys):
    """The printed table, summary and ROI columns of the port's eval_recon
    equal the root script's, and both draw the plot."""
    res, _ = _eval_pickles(recon_dir, tmp_path)
    y, x = res["exam"]["ssim_image"].shape[-2:]
    roi = np.zeros((y, x), bool)
    roi[y // 4: y // 2, x // 4: x // 2] = True
    res["exam"]["roi"] = roi
    pkl = str(tmp_path / "roi.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(res, f)
    args = ["--pickle-a", pkl, "--pickle-b", pkl, "--label-a", "a",
            "--label-b", "b"]
    capsys.readouterr()
    df = eval_recon.main(args + ["--out", str(tmp_path / "ours.png")])
    ours = capsys.readouterr().out.splitlines()
    _root("eval_recon").main(args + ["--out", str(tmp_path / "ref.png")])
    ref = capsys.readouterr().out.splitlines()
    assert ours[:-1] == ref[:-1]
    assert "a_roi" in ours[0] and "delta_roi" in ours[0]
    assert abs(df["a_roi"]["exam"]
               - float(res["exam"]["ssim_image"][..., roi].mean())) < 1e-12
    assert (tmp_path / "ours.png").stat().st_size > 0
    assert (tmp_path / "ref.png").stat().st_size > 0


def test_display_data_equals_jax(recon_dir, tmp_path):
    """The frame grid and the GIF of the same CFL: the PNG bit for bit, the
    GIF frames equal."""
    from PIL import Image, ImageSequence

    src = str(recon_dir / "exam_12accel.im")
    for phase in ([], ["--phase"]):
        out = {}
        for tag, main in (("ours", display_data.main),
                          ("ref", _root("display_data").main)):
            png = str(tmp_path / f"{tag}.png")
            gif = str(tmp_path / f"{tag}.gif")
            main([src, "--out", png, "--gif", gif, "--slice", "1"] + phase)
            out[tag] = (png, gif)
        assert Path(out["ours"][0]).read_bytes() == Path(
            out["ref"][0]).read_bytes()
        frames = [[np.asarray(f.convert("L")) for f in
                   ImageSequence.Iterator(Image.open(p[1]))]
                  for p in (out["ours"], out["ref"])]
        assert len(frames[0]) == len(frames[1]) == 4
        for a, b in zip(*frames):
            np.testing.assert_array_equal(a, b)


def test_write_dcm_equals_jax(recon_dir, tmp_path):
    """The windowed int16 pixels equal the root script's on the same volume,
    always; where pydicom does not import, both write the same npz and
    metadata; where it does, the port writes a DICOM a (slice, phase)."""
    rng = np.random.RandomState(1)
    mag = np.abs(rng.randn(2, 4, 24, 16)).astype(np.float32)
    np.testing.assert_array_equal(write_dcm.window_int16(mag),
                                  _root("write_dcm").window_int16(mag))
    src = str(recon_dir / "exam_12accel.im")
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    write_dcm.main([src, "--out-directory", str(ours)])
    _root("write_dcm").main([src, "--out-directory", str(ref)])
    try:
        import pydicom
    except ImportError:
        pydicom = None
    if pydicom is None:
        a = np.load(ours / "series_int16.npz")["pixels"]
        b = np.load(ref / "series_int16.npz")["pixels"]
        assert a.dtype == np.int16 and a.shape == (2, 4, 24, 16)
        np.testing.assert_array_equal(a, b)
        assert (json.loads((ours / "series_meta.json").read_text())
                == json.loads((ref / "series_meta.json").read_text()))
    else:
        files = sorted(ours.glob("IM*.dcm"))
        assert len(files) == 8
        assert sorted(p.name for p in ref.glob("IM*.dcm")) == [
            p.name for p in files]
        ds = pydicom.dcmread(str(files[0]))
        np.testing.assert_array_equal(
            ds.pixel_array, pydicom.dcmread(str(ref / files[0].name)
                                            ).pixel_array)


def test_batch_recon_equals_jax(tmp_path):
    """At acceleration 1 over two H5 files: the same folder name and the
    same fully-sampled adjoint CFLs as the root script."""
    pytest.importorskip("h5py")
    data = str(tmp_path / "h5")
    write_synthetic_dataset(data, num_files=2, slices=1, seed=0,
                            T=6, Y=24, X=16, C=2)
    args = ["--config-file", str(REPO / "configs/smoke.yaml"),
            "--ckpt", str(tmp_path / "none"), "--data-directory", data,
            "--acceleration", "1"]
    outs = batch_recon.main(args + ["--out-directory", str(tmp_path / "ours"),
                                    "--device", "cpu"])
    _root("batch_recon").main(args + ["--out-directory",
                                      str(tmp_path / "ref")])
    ours = sorted(glob.glob(str(tmp_path / "ours" / "*" / "*.im.hdr")))
    ref = sorted(glob.glob(str(tmp_path / "ref" / "*" / "*.im.hdr")))
    assert len(ours) == len(ref) == 2 == len(outs)
    for a, b in zip(ours, ref):
        assert (os.path.relpath(a, tmp_path / "ours")
                == os.path.relpath(b, tmp_path / "ref"))
        x, y = cfl.read(a[:-4], order="F"), jax_cfl.read(b[:-4], order="F")
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=1e-6,
                                   atol=1e-6 * np.abs(y).max())
