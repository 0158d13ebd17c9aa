"""The quality row of the port: `quality_cfg` against the quality YAMLs, the
quality set made in memory against the JAX package's H5 files, the
zero-filled row of exam synthetic_000 against the committed CSV, the
--train path of quality_row at a cut size, and the seeded validation
batches the row feeds against the JAX package's, which read the H5 files'
paths."""

import argparse
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.data.preprocess import CinePreprocess as JaxPreprocess
from dl_swin_gan_tpu.data.synthetic import write_synthetic_dataset
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.data import DataLoader, Hdf5Dataset, InMemoryDataset
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import quality_split
from dl_swin_gan_tpu_torch.scripts import quality_row
from dl_swin_gan_tpu_torch.train import CheckpointManager, DSLRTrainer
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


def test_dit_ema_quality_cfg_matches_yaml():
    """quality_cfg("float32", "dit_ema") is configs/quality/dit_ema.yaml,
    field for field: 2 unrolls of 4 layers x 6 heads x 192 (DDPM_X), the
    StepLR, a checkpoint every 64 steps, the sampled recon SSIM every 100
    epochs."""
    ours = quality_cfg("float32", "dit_ema")
    ref = load_cfg(str(REPO / "configs/quality/dit_ema.yaml"))
    assert ref.EVAL.RECON_SSIM_EVERY_N_EPOCHS == 100
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


def test_validation_batches_match_the_jax_rows():
    """The DSLR row's seeded validation batches (quality_row.fit_data, the
    preprocess DSLRTrainer validates with) equal the JAX CinePreprocess's
    on each validate file under the path the JAX run's Hdf5Dataset gave it,
    `runs/quality/data/validate/synthetic_00k.h5` (configs/quality/
    dslr.yaml's DATASET.VAL), bit for bit in the mask; under the bare name
    the mask differs. Training names are paths too; their draws are
    unseeded."""
    args = argparse.Namespace(files=2, slices=1, shape="6,48,96,2")
    cfg = quality_cfg("float32", "dslr")
    train_files, val_files = quality_row.fit_data(cfg, args)
    assert [f[0] for f in train_files] == [
        f"runs/quality/data/train/synthetic_00{i}.h5" for i in (0, 1)]
    jcfg = jax_load_cfg(str(REPO / "configs/quality/dslr.yaml"))
    assert tuple(jcfg.DATASET.VAL) == tuple(cfg.DATASET.VAL)
    ours = DSLRTrainer(cfg, device="cpu").make_preprocess(
        aug_node=cfg.AUG_VAL, use_seed=True)
    ref = JaxPreprocess(jcfg, aug_node=jcfg.AUG_VAL, use_seed=True,
                        lr_decom=True)
    for i, (path, ks, mp, tg) in enumerate(val_files):
        assert path == f"runs/quality/data/validate/synthetic_00{i}.h5"
        a = ours(ks[0], mp[0], tg[0], path)
        b = ref(ks[0], mp[0], tg[0], path)
        assert np.array_equal(a["mask"], np.asarray(b["mask"]))
        for key in ("kspace", "target", "init_image"):
            np.testing.assert_allclose(a[key], np.asarray(b[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        bare = ref(ks[0], mp[0], tg[0], Path(path).stem)
        assert not np.array_equal(a["mask"], np.asarray(bare["mask"]))
