"""DSLR serving in the torch port against the JAX package's
`scripts/reconstruct_lr.py`, on converted weights at a toy geometry:
`LRReconstructor` against the JAX pieces that script composes
(ResampleTransform, decompose_init, BlockOp, model.apply, * scale); the
port's `scripts/reconstruct_lr.py` (`reconstruct_h5_file`) against the
JAX script's CFL (the same file layout); `reconstruct_exam` on the arrays;
`quality_row --kind dslr` end to end with one training epoch.

Run as a script it serves quality-set exams with trained weights (a
state_dict the port's trainer saved, such as the DSLR row's) at 12x through
the port's LRReconstructor and through the JAX script's pieces on the same
weights (`torch_to_flax`), on the CPU, and prints each exam's rel L2 between
the two and both packages' SSIM and PSNR against the 1x adjoint:

    python -m tests.test_torch_dslr_serving WEIGHTS.pt [--exams N]
"""

import argparse
import csv
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dl_swin_gan_tpu.infer as jax_infer
from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.data import cfl as jax_cfl
from dl_swin_gan_tpu.infer.transforms import (
    ResampleTransform as JaxResampleTransform,
)
from dl_swin_gan_tpu.ops.llr import BlockOp as JaxBlockOp
from dl_swin_gan_tpu.ops.llr import decompose_init as jax_decompose_init
from dl_swin_gan_tpu.solvers.dslr import (
    build_dslr_solver as jax_build_dslr_solver,
)
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch, torch_to_flax
from dl_swin_gan_tpu_torch.data import cfl
from dl_swin_gan_tpu_torch.data.synthetic import (
    quality_split, write_synthetic_dataset,
)
from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_volumes
from dl_swin_gan_tpu_torch.infer import (
    LRReconstructor, make_reconstructor, reconstruct_exam,
)
from dl_swin_gan_tpu_torch.infer.reconstruct import accel_transform
from dl_swin_gan_tpu_torch.infer.transforms import ResampleTransform
from dl_swin_gan_tpu_torch.scripts import quality_row, reconstruct_lr
from dl_swin_gan_tpu_torch.train import CheckpointManager, DSLRTrainer
from tests.test_torch_dslr import _jax_params as jax_dslr_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs" / "config_dslr.yaml")
# config_dslr.yaml cut to a toy width
OPTS = ["MODEL.PARAMETERS.NUM_UNROLLS", "2",
        "MODEL.PARAMETERS.NUM_FEATURES", "8",
        "MODEL.PARAMETERS.DSLR.BLOCK_SIZE", "8",
        "MODEL.PARAMETERS.DSLR.NUM_BASIS", "3",
        "MODEL.PARAMETERS.DSLR.NUM_CG_STEPS", "3"]
SHAPE = dict(T=6, Y=40, X=24, C=2, E=2)
ACCEL = 12
TOL = 1e-4


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfgs(pgd=False):
    opts = OPTS + (["MODEL.META_ARCHITECTURE", "dslr-pgd"] if pgd else [])
    jcfg = jax_load_cfg(CONFIG, freeze=False)
    jcfg.merge_from_list(opts)
    jcfg.freeze()
    cfg = load_cfg(CONFIG, freeze=False)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return jcfg, cfg, opts


@pytest.fixture(scope="module")
def exam(tmp_path_factory):
    """One H5 file of 2 slices at the toy geometry."""
    pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("dslr_h5")
    (path,) = write_synthetic_dataset(str(root), num_files=1, slices=2,
                                      seed=5, **SHAPE)
    import h5py
    with h5py.File(path, "r") as f:
        return path, f["kspace"][()], f["maps"][()]


def _jax_inputs(jcfg, k, m):
    """`scripts/reconstruct_lr.py`'s steps for one slice up to the solver,
    in JAX: (the solver's inputs, its BlockOp, scale)."""
    p = jcfg.MODEL.PARAMETERS
    ex = JaxResampleTransform(ACCEL, jcfg)(k, m)
    L0, R0 = jax_decompose_init(ex["init_image"][None], p.DSLR.BLOCK_SIZE,
                                p.DSLR.NUM_BASIS,
                                overlapping=p.DSLR.OVERLAPPING)
    op = JaxBlockOp(p.DSLR.BLOCK_SIZE, (1,) + ex["init_image"].shape,
                    overlapping=p.DSLR.OVERLAPPING)
    args = (ex["kspace"][None], ex["maps"][None], ex["mask"][None], L0, R0)
    return args, op, ex["scale"]


def _jax_params(jcfg, model, kspace, maps):
    """The JAX solver's weights drawn with numpy in the shapes of its init
    (tests/test_torch_dslr.py `_jax_params`)."""
    args, op, _ = _jax_inputs(jcfg, kspace[0], maps[0])
    return jax_dslr_params(model, jcfg.MODEL.META_ARCHITECTURE, *args,
                           block_op=op)


@pytest.mark.parametrize("pgd", (False, True), ids=("cg-v1", "pgd"))
def test_lr_reconstructor_matches_jax_pieces(exam, pgd):
    """Every slice through LRReconstructor on converted weights against the
    JAX pieces: rel L2 1e-4; make_reconstructor picks it."""
    _, kspace, maps = exam
    jcfg, cfg, _ = _cfgs(pgd)
    model = jax_build_dslr_solver(jcfg)
    params, apply, want = _jax_params(jcfg, model, kspace, maps), None, []
    for s in range(len(kspace)):
        args, op, scale = _jax_inputs(jcfg, kspace[s], maps[s])
        if apply is None:           # every slice has one shape
            apply = jax.jit(lambda p_, *a: model.apply({"params": p_}, *a,
                                                       op))
        want.append(np.asarray(apply(params, *args)) * scale)
    recon = make_reconstructor(cfg, flax_to_torch(params), device="cpu")
    assert isinstance(recon, LRReconstructor)
    transform = ResampleTransform(ACCEL, cfg)
    examples = [transform(kspace[s], maps[s]) for s in range(len(kspace))]
    batch = {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}
    got = recon(batch)
    assert got.dtype == np.complex64 and got.shape == (2, 2, 6, 40, 24)
    assert _rel(got, np.concatenate(want)) <= TOL


def test_reconstruct_lr_script_matches_jax_script(exam, tmp_path,
                                                  monkeypatch):
    """The port's CLI on a checkpoint of its trainer against the JAX
    script on the same weights (its checkpoint loader handed them): the
    same file name, CFL shape and order, values within 1e-4;
    reconstruct_exam on the file's arrays writes the same bits."""
    path, kspace, maps = exam
    jcfg, cfg, opts = _cfgs()
    params = _jax_params(jcfg, jax_build_dslr_solver(jcfg), kspace, maps)
    monkeypatch.setattr(jax_infer, "load_checkpoint_params",
                        lambda *a, **k: params)
    from scripts.reconstruct_lr import main as jax_main
    jax_main(["--config-file", CONFIG, "--ckpt", "unused", "--file", path,
              "--out-directory", str(tmp_path / "jax"), "--acceleration",
              str(ACCEL)] + opts)
    theirs = jax_cfl.read(str(tmp_path / "jax" / "synthetic_000_12accel.im"),
                          order="F")

    state_dict = flax_to_torch(params)
    state = DSLRTrainer(cfg, device="cpu").init_state(state_dict=state_dict)
    CheckpointManager(str(tmp_path / "ckpt")).save(0, state)
    out = reconstruct_lr.main(
        ["--config-file", CONFIG, "--ckpt", str(tmp_path / "ckpt"),
         "--file", path, "--out-directory", str(tmp_path / "port"),
         "--acceleration", str(ACCEL), "--device", "cpu"] + opts)
    assert out.endswith("synthetic_000_12accel.im")
    ours = cfl.read(out, order="F")
    assert ours.shape == theirs.shape == (24, 40, 2, 2, 6, 1, 1, 1)
    assert _rel(ours, theirs) <= TOL
    lib = reconstruct_exam("synthetic_000", kspace, maps,
                           str(tmp_path / "lib"), cfg,
                           LRReconstructor(cfg, state_dict, device="cpu"),
                           ACCEL)
    assert lib.endswith("synthetic_000_12accel.im")
    assert np.array_equal(cfl.read(lib, order="F"), ours)


def test_quality_row_dslr_kind(tmp_path):
    """--kind dslr --train on a cut of the quality set: DSLRTrainer through
    the device pipeline for one epoch (2 steps), validation, the test exam
    served by LRReconstructor and scored; --kind dslr refuses another
    family's model."""
    out = tmp_path / "row"
    rc = quality_row.main([
        "--kind", "dslr", "--train", "--device", "cpu", "--files", "1",
        "--slices", "2", "--shape", "6,48,24,2", "--max-epochs", "1",
        "--out", str(out), "--draw-seed", "3",
        "AUG_TRAIN.CROP_READOUT", "16", "AUG_VAL.CROP_READOUT", "16",
        "EVAL.RUN_EVERY_N_EPOCHS", "1"] + OPTS)
    assert rc == 0
    assert CheckpointManager(str(out / "train" / "checkpoints")
                             ).latest_step() == 2
    (row,) = list(csv.DictReader((out / "eval_12accel.csv").open()))
    assert row["name"] == "synthetic_000"
    assert -1.0 <= float(row["ssim"]) <= 1.0
    assert np.isfinite(float(row["psnr"]))
    with pytest.raises(SystemExit):
        quality_row.main(["--kind", "dslr", "--model", "se", "--train",
                          "--device", "cpu"])


def serve_both(state, exams=1):
    """The first `exams` test exams of the quality set at 12x through the
    port's LRReconstructor and the JAX script's pieces (the DSLR row's
    config, configs/quality/dslr.yaml) on the CPU, with `state` (the port's
    state_dict): yields (name, port images, JAX images, 1x reference), each
    [slices, E, T, Y, X]."""
    cfg = load_cfg(str(REPO / "configs/quality/dslr.yaml"))
    jcfg = jax_load_cfg(str(REPO / "configs/quality/dslr.yaml"))
    p = jcfg.MODEL.PARAMETERS
    model = jax_build_dslr_solver(jcfg)
    params = torch_to_flax(state, cfg.MODEL.MODEL_TYPE)
    ours = LRReconstructor(cfg, state, device="cpu")
    resample, full = accel_transform(cfg, ACCEL), accel_transform(cfg, 1)
    apply = None
    for name, kspace, maps, _ in quality_split("test", exams):
        port, theirs, ref = [], [], []
        for s in range(len(kspace)):
            port.append(ours({k: v[None] for k, v in
                              resample(kspace[s], maps[s]).items()}))
            ex = JaxResampleTransform(ACCEL, jcfg)(kspace[s], maps[s])
            if apply is None:       # every slice has one shape
                op = JaxBlockOp(p.DSLR.BLOCK_SIZE,
                                (1,) + ex["init_image"].shape,
                                overlapping=p.DSLR.OVERLAPPING)
                apply = jax.jit(lambda p_, *a: model.apply(
                    {"params": p_}, *a, op))
            L0, R0 = jax_decompose_init(ex["init_image"][None],
                                        p.DSLR.BLOCK_SIZE, p.DSLR.NUM_BASIS,
                                        overlapping=p.DSLR.OVERLAPPING)
            pred = apply(params, ex["kspace"][None], ex["maps"][None],
                         ex["mask"][None], L0, R0)
            theirs.append(np.asarray(pred) * ex["scale"])
            ex = full(kspace[s], maps[s])
            ref.append(ex["init_image"] * ex["scale"])
        yield (name, np.concatenate(port), np.concatenate(theirs),
               np.stack(ref).astype(np.complex64))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("weights", help="torch.save'd {'model': state_dict} "
                                        "or a state_dict")
    parser.add_argument("--exams", type=int, default=1)
    args = parser.parse_args(argv)
    payload = torch.load(args.weights, map_location="cpu", weights_only=True)
    state = payload.get("model", payload)
    for name, port, theirs, ref in serve_both(state, args.exams):
        line = [f"{name}: port vs JAX rel L2 {_rel(port, theirs):.3e}"]
        for tag, images in (("port", port), ("jax", theirs)):
            m = evaluate_volumes(ref, images)
            line.append(f"{tag} " + ", ".join(
                f"{k} {float(np.mean(v)):.5f}" for k, v in m.items()))
        print("; ".join(line), flush=True)


if __name__ == "__main__":
    main()
