"""The port's device-resident input pipeline against the JAX package's
(`data/device_pipeline.py`) and against the port's host `CinePreprocess`,
on the CPU at toy shapes: the host draws bit for bit, the physics
(complex64 here against the host's complex128) within rtol 2e-4, the DSLR
L R^H, the loader's order over epochs, and fit through the pipeline for
Trainer, DSLRTrainer and GANTrainer."""

import json
import logging

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.data.device_pipeline import (
    DevicePipeline as JaxPipeline, DevicePipelineLoader as JaxLoader,
)
from dl_swin_gan_tpu.data.synthetic import write_synthetic_dataset
from dl_swin_gan_tpu.ops.llr import BlockOp as JaxBlockOp
from dl_swin_gan_tpu.ops.llr import compose as jax_compose
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.data.device_pipeline import (
    DevicePipeline, DevicePipelineLoader,
)
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, synthetic_files,
)
from dl_swin_gan_tpu_torch.ops.llr import BlockOp, compose
from dl_swin_gan_tpu_torch.train import DSLRTrainer, GANTrainer, Trainer

torch.set_num_threads(1)

SHAPE = dict(T=6, Y=32, X=24, C=4, E=2)
KEYS = ("kspace", "maps", "target", "init_image")


def _cfg(get, slwin=True, crop=16, partial_kx=0.0, zpad=0):
    """The JAX package's test config (tests/test_device_pipeline.py), from
    either package's get_cfg."""
    cfg = get()
    cfg.MODEL.MODEL_TYPE = "RES"
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 1
    cfg.MODEL.PARAMETERS.NUM_RESBLOCKS = 1
    cfg.MODEL.PARAMETERS.NUM_FEATURES = 8
    cfg.MODEL.PARAMETERS.SLWIN_INIT = slwin
    cfg.AUG_TRAIN.CROP_READOUT = crop
    cfg.AUG_TRAIN.ZPAD_PE = zpad
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (3, 4)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KX = partial_kx
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    return cfg


def _ours(cfg, k, m, fname, **kw):
    pipe = DevicePipeline(cfg, use_seed=True, device="cpu", **kw)
    params = pipe.draw_params(fname, k.shape)
    got = pipe.build(pipe.upload_raw(k, m), params)
    return params, {key: v.numpy() for key, v in got.items()}


def _theirs(cfg, k, m, fname, **kw):
    pipe = JaxPipeline(cfg, use_seed=True, **kw)
    params = pipe.draw_params(fname, k.shape)
    got = packing.unpack_np(pipe.build(pipe.upload_raw(k, m), params))
    return params, got


def _close(got, ref, key):
    mag = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * max(mag, 1.0),
                               err_msg=key)


@pytest.mark.parametrize("slwin,crop,partial_kx,zpad", [
    (True, 16, 0.0, 0), (False, 0, 0.25, 0), (True, 16, 0.0, 24)])
def test_pipeline_matches_jax_pipeline_and_host(slwin, crop, partial_kx, zpad):
    """The draws (crop starts, flips, mask) bit for bit with the JAX
    pipeline's; the batch within rtol 2e-4 of the JAX pipeline's and of the
    port's host CinePreprocess, with the same mask."""
    cfg = _cfg(get_cfg, slwin, crop, partial_kx, zpad)
    jcfg = _cfg(jax_get_cfg, slwin, crop, partial_kx, zpad)
    k, m, t = make_cine_example(**SHAPE, seed=3)

    params, got = _ours(cfg, k, m, "devpipe_ex")
    jparams, ref = _theirs(jcfg, k, m, "devpipe_ex")
    assert set(params) == set(jparams)
    for key in params:
        np.testing.assert_array_equal(params[key], jparams[key], err_msg=key)
    assert set(got) == set(ref) == set(Trainer.batch_keys)
    host = CinePreprocess(cfg, use_seed=True)(k, m, t, "devpipe_ex")

    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["mask"][0], host["mask"])
    assert got["scale"].shape == (1,) and got["scale"].dtype == np.float32
    np.testing.assert_allclose(got["scale"][0], host["scale"], rtol=1e-4)
    np.testing.assert_allclose(got["scale"], ref["scale"], rtol=1e-4)
    for key in KEYS:
        assert got[key].dtype == np.complex64 and got[key].shape[0] == 1, key
        _close(got[key][0], host[key], key)
        _close(got[key], ref[key], key)


def test_pipeline_lr_decom_matches_jax_and_host():
    """lr_decom: the truncated block SVD on the device. SVD factor phases
    differ between libraries, so L R^H is what is compared."""
    cfg = _cfg(get_cfg)
    jcfg = _cfg(jax_get_cfg)
    for c in (cfg, jcfg):
        c.MODEL.PARAMETERS.DSLR.BLOCK_SIZE = 8
        c.MODEL.PARAMETERS.DSLR.NUM_BASIS = 3
    k, m, t = make_cine_example(**SHAPE, seed=5)

    _, got = _ours(cfg, k, m, "lr_ex", lr_decom=True)
    _, ref = _theirs(jcfg, k, m, "lr_ex", lr_decom=True)
    host = CinePreprocess(cfg, use_seed=True, lr_decom=True)(k, m, t, "lr_ex")
    assert got["L_init"].shape == ref["L_init"].shape
    assert got["L_init"].shape[1:] == host["L_init"].shape
    assert got["R_init"].shape[1:] == host["R_init"].shape
    assert got["L_init"].dtype == got["R_init"].dtype == np.complex64

    image_shape = (1, 2) + host["target"].shape[1:]
    ours = compose(torch.from_numpy(got["L_init"][0]),
                   torch.from_numpy(got["R_init"][0]),
                   BlockOp(8, image_shape)).numpy()
    jax_img = np.asarray(jax_compose(ref["L_init"][0], ref["R_init"][0],
                                     JaxBlockOp(8, image_shape, xp=np)))
    host_img = compose(host["L_init"], host["R_init"],
                       BlockOp(8, image_shape, xp=np))
    for name, other in (("jax", jax_img), ("host", host_img)):
        np.testing.assert_allclose(ours, other, rtol=2e-3,
                                   atol=2e-4 * np.abs(other).max(),
                                   err_msg=name)


def test_pipeline_diffusion_raises():
    """diffusion=True builds diffusion batches (it raised before they were
    ported): DDPM_X draws mask_r and mask_p after the mask, DDPM_E takes
    the mask for both; no raw k-space in either
    (tests/test_torch_diffusion.py holds them against the JAX pipeline)."""
    k, m, _ = make_cine_example(seed=0, **SHAPE)
    for meta in ("DDPM_X", "DDPM_E"):
        cfg = _cfg(get_cfg)
        cfg.MODEL.META_ARCHITECTURE = meta
        params, got = _ours(cfg, k, m, "d0", diffusion=True)
        assert "kspace" not in got
        assert ("mask_r" in params) == (meta == "DDPM_X")
        assert (got["mask_r"] + got["mask_p"] == got["mask"]).all() \
            if meta == "DDPM_X" else (got["mask_r"] == got["mask"]).all()


def test_pipeline_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePipeline(_cfg(get_cfg))


def _order(loader, epochs):
    """The examples' indices the loader visits in each of `epochs` epochs
    (its build replaced by the raw example)."""
    loader.pipe.build = lambda raw, params: raw
    out = []
    for _ in range(epochs):
        out.append([next(i for i, r in enumerate(loader._raw) if r is raw)
                    for raw in loader])
    return out


def test_loader_order_matches_jax_loader(tmp_path):
    """Over 3 epochs, the port's loader on the H5 directory, and on the
    same files held in memory, visits the examples in the JAX loader's
    order, with the same names."""
    pytest.importorskip("h5py")
    write_synthetic_dataset(str(tmp_path), num_files=3, slices=2, seed=0,
                            **SHAPE)
    cfg, jcfg = _cfg(get_cfg), _cfg(jax_get_cfg)
    ours = DevicePipelineLoader(str(tmp_path), cfg, seed=7, device="cpu")
    theirs = JaxLoader(str(tmp_path), jcfg, seed=7)
    files = list(synthetic_files(3, slices=2, seed=0, **SHAPE))
    memory = DevicePipelineLoader(None, cfg, seed=7, files=files,
                                  device="cpu")
    assert len(ours) == len(theirs) == len(memory) == 6
    assert ours._names == theirs._names
    assert [n.rsplit("/", 1)[1][:-3] for n in ours._names] == memory._names
    np.testing.assert_array_equal(ours._raw[3]["kspace"].numpy()[0],
                                  memory._raw[3]["kspace"].numpy()[0])
    order = _order(ours, 3)
    assert order == _order(theirs, 3) == _order(memory, 3)
    assert len({tuple(o) for o in order}) == 3   # each epoch reshuffles


def _fit_cfg(tmp_path, cfg):
    cfg.DATALOADER.DEVICE_PIPELINE = True
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.LOGGER.LOG_METRICS_EVERY_N_STEPS = 1
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.DATASET.VAL = ()
    return cfg


def _losses(tmp_path, key="Train/complex_l1"):
    recs = [json.loads(line) for line in
            open(tmp_path / "out" / "metrics.jsonl")]
    return [r[key] for r in recs if key in r]


def test_fit_with_device_pipeline(tmp_path):
    """Trainer.fit through the pipeline, from an H5 directory: 2 files x 1
    slice x 3 epochs; the loss falls."""
    pytest.importorskip("h5py")
    train = str(tmp_path / "train")
    write_synthetic_dataset(train, num_files=2, slices=1, seed=0, **SHAPE)
    cfg = _fit_cfg(tmp_path, _cfg(get_cfg))
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 2
    cfg.OPTIMIZER.ADAM.LR = 0.002
    cfg.DATASET.TRAIN = (train,)
    trainer = Trainer(cfg, device="cpu")
    assert trainer._use_device_pipeline()
    state = trainer.fit(max_epochs=3)
    assert state.step == 6
    losses = _losses(tmp_path)
    assert len(losses) == 6 and losses[-1] < losses[0]


def test_device_pipeline_needs_batch_one(caplog):
    """At another TRAIN_BATCH_SIZE the host loader feeds training, with a
    log line, as in the JAX package."""
    cfg = _cfg(get_cfg)
    cfg.DATALOADER.DEVICE_PIPELINE = True
    cfg.DATALOADER.TRAIN_BATCH_SIZE = 2
    with caplog.at_level(logging.INFO):
        assert not Trainer(cfg, device="cpu")._use_device_pipeline()
    assert "host loader" in caplog.text


def test_dslr_fit_with_device_pipeline(tmp_path):
    """DSLRTrainer.fit through the pipeline (lr_decom on the device), on
    files held in memory: 2 files x 1 slice x 2 epochs."""
    cfg = _fit_cfg(tmp_path, _cfg(get_cfg))
    cfg.MODEL.META_ARCHITECTURE = "dslr-cg-v1"
    p = cfg.MODEL.PARAMETERS
    p.DSLR.BLOCK_SIZE = 8
    p.DSLR.NUM_BASIS = 2
    p.DSLR.NUM_CG_STEPS = 2
    trainer = DSLRTrainer(cfg, device="cpu")
    assert trainer._device_pipeline_kwargs() == {"lr_decom": True}
    files = list(synthetic_files(2, slices=1, seed=0, **SHAPE))
    state = trainer.fit(max_epochs=2, train_data=files)
    assert state.step == 4
    losses = _losses(tmp_path)
    assert len(losses) == 4 and np.isfinite(losses).all()


def test_gan_fit_with_device_pipeline(tmp_path):
    """GANTrainer.fit through the pipeline at toy widths: 2 files x 1 slice
    x 3 epochs; the reconstruction loss falls and both adversarial losses
    are logged."""
    cfg = _fit_cfg(tmp_path, _cfg(get_cfg))
    cfg.MODEL.MODEL_TYPE = "SWIN"
    p = cfg.MODEL.PARAMETERS
    p.NUM_SWINBLOCKS = 1
    p.NUM_FEATURES = 8
    p.CONV_BLOCK.COMPLEX = False
    cfg.MODEL.GAN.DISC_FEATURES = 4
    cfg.MODEL.GAN.DISC_LAYERS = 1
    cfg.OPTIMIZER.ADAM.LR = 0.002
    files = list(synthetic_files(2, slices=1, seed=0, T=8, Y=32, X=24, C=4,
                                 E=2))
    trainer = GANTrainer(cfg, device="cpu")
    assert trainer._use_device_pipeline()
    state = trainer.fit(max_epochs=3, train_data=files)
    assert state.step == 6
    losses = _losses(tmp_path)
    assert len(losses) == 6 and losses[-1] < losses[0]
    for key in ("Train/disc_loss", "Train/adv_loss"):
        assert np.isfinite(_losses(tmp_path, key)).all()


def _epoch(loader, keys=("mask", "kspace", "target")):
    return [{k: b[k].numpy() if isinstance(b[k], torch.Tensor)
             else np.asarray(b[k]) for k in keys} for b in loader]


def _same(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_draw_seed_repeats_the_training_draws():
    """Two loaders with one draw seed give identical batches over two
    epochs (masks, crops, flips), on the device pipeline and through the
    host preprocess; another seed gives other masks; without one the
    draws stay unseeded."""
    cfg = _cfg(get_cfg)
    files = list(synthetic_files(2, slices=2, seed=0, **SHAPE))

    def device(seed):
        loader = DevicePipelineLoader(None, cfg, seed=7, files=files,
                                      device="cpu", draw_seed=seed)
        return _epoch(loader) + _epoch(loader)

    def host(seed):
        pre = CinePreprocess(cfg, draw_seed=seed)
        return [pre(k[s], m[s], t[s], name) for _ in range(2)
                for name, k, m, t in files for s in range(len(k))]

    for run in (device, host):
        a, b, c = run(5), run(5), run(6)
        assert _same(a, b), run.__name__
        assert not all(np.array_equal(x["mask"], y["mask"])
                       for x, y in zip(a, c)), run.__name__
        # the k-th draw: the two epochs of one loader differ
        assert not all(np.array_equal(x["mask"], y["mask"]) for x, y in
                       zip(a[:len(a) // 2], a[len(a) // 2:])), run.__name__
    unseeded = [DevicePipelineLoader(None, cfg, seed=7, files=files,
                                     device="cpu") for _ in range(2)]
    assert unseeded[0].pipe.draw_seed is None
    assert not _same(*(_epoch(u) for u in unseeded))   # the same order
