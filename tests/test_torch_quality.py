"""The quality row of the port: `quality_cfg` against the quality YAMLs, the
quality set made in memory against the JAX package's H5 files, the
zero-filled row of exam synthetic_000 against the committed CSV, and the
driver's --train path at a cut size."""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.data.synthetic import write_synthetic_dataset
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.data import DataLoader, Hdf5Dataset, InMemoryDataset
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import quality_split
from dl_swin_gan_tpu_torch.scripts import quality_row
from dl_swin_gan_tpu_torch.train import CheckpointManager
from dl_swin_gan_tpu_torch.utils.headline import quality_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ZF_CSV = REPO / "runs/quality/zf_r4/eval_12accel.csv"
# a cut of the quality set small enough for the CPU
CUT = dict(slices=2, T=6, Y=48, X=24, C=2)


@pytest.mark.parametrize("dtype,yaml", [("float32", "resnet.yaml"),
                                        ("bfloat16", "resnet_bf16.yaml")])
def test_quality_cfg_matches_yaml(dtype, yaml):
    """Field for field, DATALOADER.DEVICE_PIPELINE included."""
    ours = quality_cfg(dtype)
    ref = load_cfg(str(REPO / "configs/quality" / yaml))
    assert ref.DATALOADER.DEVICE_PIPELINE and ours.DATALOADER.DEVICE_PIPELINE
    for node in ref:
        assert ours[node] == ref[node], node
    assert set(ours) == set(ref)


@pytest.mark.parametrize("split", ["train", "validate", "test"])
def test_quality_split_matches_jax_h5_files(split, tmp_path):
    """The in-memory split against the files the JAX package's
    write_synthetic_dataset writes with make_quality_set.sh's seeds, at a
    reduced size: the same names and arrays, bit for bit."""
    h5py = pytest.importorskip("h5py")
    offset = {"train": 0, "validate": 10_000, "test": 20_000}[split]
    paths = write_synthetic_dataset(
        str(tmp_path), num_files=2, seed=offset, noise=0.002,
        E=2, **{k: v for k, v in CUT.items()})
    ours = quality_split(split, num_files=2, **CUT)
    assert [name for name, *_ in ours] == [Path(p).stem for p in paths]
    for (name, ks, mp, tg), path in zip(ours, paths):
        with h5py.File(path, "r") as f:
            for key, arr in (("kspace", ks), ("maps", mp), ("target", tg)):
                assert arr.dtype == f[key].dtype and np.array_equal(
                    arr, f[key][()]), (name, key)


def test_in_memory_dataset_matches_hdf5_dataset(tmp_path):
    """The same (file, slice) examples in the same order as an Hdf5Dataset
    of the same files; the transform gets the file's name for its path."""
    pytest.importorskip("h5py")
    files = quality_split("validate", num_files=2, **CUT)
    write_synthetic_dataset(str(tmp_path), num_files=2, seed=10_000,
                            noise=0.002, E=2, **CUT)

    def transform(kspace, maps, target, name):
        return {"kspace": kspace, "maps": maps, "target": target,
                "name": Path(name).stem}

    ours = InMemoryDataset(files, transform)
    ref = Hdf5Dataset(str(tmp_path), transform)
    assert len(ours) == len(ref) == 4
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a["name"] == b["name"] == f"synthetic_{i // 2:03d}"
        for key in ("kspace", "maps", "target"):
            assert np.array_equal(a[key], b[key]), key
    pre = CinePreprocess(quality_cfg(), use_seed=True)
    batches = list(DataLoader(InMemoryDataset(files, pre), batch_size=2,
                              shuffle=False))
    assert len(batches) == 2 and batches[0]["kspace"].shape == (2, 2, 6, 48, 24)


def test_zerofilled_row_of_exam_000_matches_committed_csv(tmp_path):
    """The zero-filled 12x row of exam synthetic_000 at full size (18 x 156
    x 96, 8 coils, 4 slices) equals the first row of the committed CSV of
    the JAX package's run to 1e-6."""
    out = tmp_path / "zf"
    assert quality_row.main(["--kind", "zerofilled", "--device", "cpu",
                             "--files", "1", "--out", str(out)]) == 0
    (row,) = list(csv.DictReader((out / "eval_12accel.csv").open()))
    ref = next(csv.DictReader(ZF_CSV.open()))
    assert row["name"] == ref["name"] == "synthetic_000"
    for key in ("ssim", "rmse", "psnr"):
        assert abs(float(row[key]) - float(ref[key])) <= 1e-6, key
    assert (out / "synthetic_000_1accel.im.hdr").exists()
    assert (out / "synthetic_000_12accel.im.hdr").exists()


def test_train_then_score_at_a_cut_size(tmp_path):
    """--train fits quality_cfg on the in-memory train split (one file of 2
    slices: 2 steps), validates, checkpoints, and scores the final step."""
    out = tmp_path / "row"
    rc = quality_row.main([
        "--kind", "unrolled", "--dtype", "bfloat16", "--train",
        "--device", "cpu", "--files", "1", "--slices", "2",
        "--shape", "6,48,24,2", "--max-epochs", "1", "--out", str(out),
        "MODEL.PARAMETERS.NUM_FEATURES", "8", "MODEL.PARAMETERS.NUM_UNROLLS",
        "2", "AUG_TRAIN.CROP_READOUT", "16", "AUG_VAL.CROP_READOUT", "16",
        "EVAL.RUN_EVERY_N_EPOCHS", "1"])
    assert rc == 0
    ckpt = CheckpointManager(str(out / "train" / "checkpoints"))
    assert ckpt.latest_step() == 2
    assert (out / "train" / "metrics.jsonl").exists()
    (row,) = list(csv.DictReader((out / "eval_12accel.csv").open()))
    assert row["name"] == "synthetic_000"
    assert -1.0 <= float(row["ssim"]) <= 1.0 and np.isfinite(float(row["psnr"]))


def test_driver_arguments():
    with pytest.raises(SystemExit):
        quality_row.main(["--kind", "unrolled", "--device", "cpu"])
    with pytest.raises(SystemExit):
        quality_row.main(["--kind", "zerofilled", "--train", "--device", "cpu"])


def test_driver_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quality_row.main(["--kind", "zerofilled", "--files", "1"])
