"""The trainers' image, video and profile logging in the port, against the
JAX package's: the arrays a recording writer gets from `_log_videos` and
`validate`; fit's losses with the logging on at every step and off,
bitwise equal (logging takes no training draw and changes no state); the
`DL_SWIN_GAN_PROFILE` trace of a 12-step fit."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.trainer import Trainer as JaxTrainer
from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, synthetic_files,
)
from dl_swin_gan_tpu_torch.train import DiffusionTrainer, Trainer
from dl_swin_gan_tpu_torch.train import trainer as trainer_module
from tests.test_torch_diffusion import toy_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
T, Y, X, C, E = 8, 24, 24, 4, 2
DIFF_SHAPE = (6, 20, 12, 3)      # tests/test_torch_diffusion_train.py's
OVERRIDES = ["MODEL.PARAMETERS.NUM_UNROLLS", 2,
             "MODEL.PARAMETERS.NUM_RESBLOCKS", 1,
             "MODEL.PARAMETERS.NUM_FEATURES", 8,
             "AUG_TRAIN.CROP_READOUT", 16,
             "AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS", (4, 5),
             "AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY", 0.0,
             "AUG_VAL.UNDERSAMPLE.ACCELERATIONS", (4, 5),
             "AUG_VAL.CROP_READOUT", 16,
             "OPTIMIZER.ADAM.LR", 0.002,
             "DATALOADER.NUM_WORKERS", 1,
             "DATALOADER.DEVICE_PIPELINE", False,
             "LOGGER.LOG_METRICS_EVERY_N_STEPS", 1]


class RecordingWriter:
    """Records what the trainers log: (kind, step, tag, array)."""

    def __init__(self, output_dir=None):
        self.records = []

    def scalars(self, step, metrics):
        for k, v in metrics.items():
            self.records.append(("scalar", step, k, float(v)))

    def image(self, step, tag, img):
        self.records.append(("image", step, tag, np.array(img)))

    def video(self, step, tag, frames, fps=7):
        self.records.append(("video", step, tag, np.array(frames)))

    def close(self):
        pass

    def arrays(self):
        return [r for r in self.records if r[0] != "scalar"]


def _cfgs(renormalize):
    yaml = str(REPO / "configs/basic/example.yaml")
    out = []
    for load in (load_cfg, jax_load_cfg):
        cfg = load(yaml, freeze=False)
        cfg.merge_from_list(OVERRIDES)
        cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = renormalize
        out.append(cfg)
    return out


def _batch(cfg, seed=0):
    pre = CinePreprocess(cfg, aug_node=cfg.AUG_VAL, use_seed=True)
    ex = pre(*make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=seed),
             f"log_{seed}")
    return {k: np.asarray(v)[None] for k, v in ex.items()}


@pytest.mark.parametrize("renormalize", [False, True])
def test_logged_arrays_match_jax(renormalize):
    """Converted weights, one batch: the videos and mask of `_log_videos`
    on the val step's prediction, and everything `validate` logs (the
    metrics, the magnitude strip, the videos) over two batches, within 1e-5
    of the largest magnitude (the phase video where the magnitude is above
    1e-3 of it)."""
    cfg, jcfg = _cfgs(renormalize)
    batches = [_batch(cfg, s) for s in (0, 1)]
    jtrainer = JaxTrainer(jcfg)
    jstate = jtrainer.init_state(batches[0])
    jtrainer._build_steps()
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(state_dict=flax_to_torch(params))

    ours, ref = RecordingWriter(), RecordingWriter()
    _, pred = trainer.val_step(state, batches[0])
    trainer._log_videos(ours, 3, batches[0], pred)
    packed = packing.pack(batches[0])
    _, jpred = jtrainer._val_step(jstate.params, packed)
    jtrainer._log_videos(ref, 3, packed, jpred)
    trainer.validate(state, batches, ours)
    jtrainer.validate(jstate, batches, ref)

    tags = [(k, s, t) for k, s, t, _ in ours.arrays()]
    assert tags == [(k, s, t) for k, s, t, _ in ref.arrays()]
    assert [t for k, s, t in tags[:4]] == [
        "Magnitude", "Phase", "MagnitudeError", "Mask"]
    assert ("image", 0, "Validate/magnitude") in tags
    magnitude = None
    for (kind, step, tag, a), (*_, b) in zip(ours.arrays(), ref.arrays()):
        b = np.asarray(b)
        assert a.shape == b.shape, tag
        if tag == "Magnitude":
            magnitude = a
        if tag == "Phase":
            keep = magnitude > 1e-3 * magnitude.max()
            diff = np.angle(np.exp(1j * (a - b)))[keep]
            assert np.abs(diff).max() <= 1e-4, tag
        else:
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), tag
    scalars = {r[2]: r[3] for r in ours.records if r[0] == "scalar"}
    jscalars = {r[2]: r[3] for r in ref.records if r[0] == "scalar"}
    assert set(scalars) == set(jscalars)
    for k in scalars:
        assert abs(scalars[k] - jscalars[k]) <= 1e-4 * abs(jscalars[k]), k


def _files(n=3, shape=(T, Y, X, C)):
    t, y, x, c = shape
    return list(synthetic_files(num_files=n, slices=1, T=t, Y=y, X=x, C=c,
                                E=E, seed=0))


def _fit_losses(trainer_cls, cfg, tmp_path, monkeypatch, key,
                shape=(T, Y, X, C)):
    """fit on 3 in-memory slices, draw-seeded, with a recording writer:
    (the train loss of each step, the writer, the final weights)."""
    writers = []

    def make_writer(output_dir):
        writers.append(RecordingWriter())
        return writers[-1]

    monkeypatch.setattr(trainer_module, "MetricsWriter", make_writer)
    cfg.OUTPUT_DIR = str(tmp_path)
    trainer = trainer_cls(cfg, device="cpu", draw_seed=7)
    state = trainer.fit(max_epochs=2, train_data=_files(shape=shape),
                        val_data=_files(1, shape))
    (writer,) = writers
    losses = [r[3] for r in writer.records if r[2] == key]
    return losses, writer, {k: v.clone() for k, v in
                            state.model.state_dict().items()}


def test_logging_leaves_the_trainer_trajectory(tmp_path, monkeypatch):
    """Trainer: 6 steps with LOG_IMAGES_EVERY_N_STEPS 1 and 0; the losses
    and final weights bitwise equal; the first run logged 6 sets of
    videos, the second none but validate's."""
    runs = []
    for every in (1, 0):
        cfg, _ = _cfgs(False)
        cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = every
        runs.append(_fit_losses(Trainer, cfg, tmp_path / str(every),
                                monkeypatch, "Train/complex_l1"))
    (on, w_on, p_on), (off, w_off, p_off) = runs
    assert len(on) == 6 and on == off
    for k in p_on:
        assert torch.equal(p_on[k], p_off[k]), k
    steps = {s for kind, s, t, _ in w_on.arrays() if t == "Mask"}
    assert steps == set(range(1, 7))
    assert {s for kind, s, t, _ in w_off.arrays() if t == "Mask"} == {3, 6}


def test_logging_leaves_the_diffusion_trajectory(tmp_path, monkeypatch):
    """DiffusionTrainer (Latte, DDPM_X): 6 steps with the sampled strip
    at every step and never; losses and weights bitwise equal; 6 strips,
    each from the EMA weights of its step."""
    runs = []
    for every in (1, 0):
        cfg = toy_cfg(get_cfg, "LATTE", "DDPM_X")
        p = cfg.MODEL.PARAMETERS
        p.FIX_STEP_SIZE = True
        p.SLWIN_INIT = False
        cfg.OPTIMIZER.ADAM.LR = 1e-3
        cfg.AUG_TRAIN.CROP_READOUT = 0
        cfg.AUG_VAL.CROP_READOUT = 0
        cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (3, 4)
        cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
        cfg.DATALOADER.NUM_WORKERS = 1
        cfg.DATALOADER.DEVICE_PIPELINE = False
        cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 1
        cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 1
        cfg.LOGGER.LOG_PREDICTION_EVERY_N_STEPS = every
        runs.append(_fit_losses(
            lambda c, **kw: DiffusionTrainer(c, sample_steps=2, **kw),
            cfg, tmp_path / str(every), monkeypatch, "Train MSE",
            shape=DIFF_SHAPE))
    (on, w_on, p_on), (off, w_off, p_off) = runs
    assert len(on) == 6 and on == off
    for k in p_on:
        assert torch.equal(p_on[k], p_off[k]), k
    strips = [(s, a) for kind, s, t, a in w_on.arrays()
              if t == "Train/sampled_magnitude"]
    assert [s for s, _ in strips] == list(range(1, 7))
    t, y, x, _ = DIFF_SHAPE
    assert all(a.shape == (y, min(t, 8) * x) and np.isfinite(a).all()
               for _, a in strips)
    assert not w_off.arrays()


def test_profile_trace(tmp_path, monkeypatch):
    """DL_SWIN_GAN_PROFILE=<dir>: a 12-step fit writes a Chrome trace of
    its first 10 steps there, holding the port's spans (utils/tracing.py)
    of every one of them."""
    cfg, _ = _cfgs(False)
    cfg.LOGGER.LOG_IMAGES_EVERY_N_STEPS = 0
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    monkeypatch.setenv("DL_SWIN_GAN_PROFILE", str(tmp_path / "trace"))
    state = Trainer(cfg, device="cpu", draw_seed=7).fit(
        max_epochs=4, train_data=_files())
    assert state.step == 12
    trace = json.loads((tmp_path / "trace" / "trace_rank0.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert any("conv" in n for n in names)
    spans = [e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"]
    for name in ("trainer.to_device", "trainer.forward", "trainer.loss",
                 "trainer.backward", "trainer.optimizer", "solver.init"):
        assert spans.count(name) == 10, name
    for name in ("solver.unroll", "solver.dc", "solver.denoise",
                 "trunk.head", "trunk.tail"):
        assert spans.count(name) == 10 * 2, name      # 2 unrolls a step
