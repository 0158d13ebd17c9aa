"""The port's mesh (`parallel/mesh.py`), the sharded loaders, data-parallel
serving, the context-parallel window attention, the multi-rank dry run and
torchrun's entry points, on the CPU over gloo (file:// rendezvous under
tmp_path; torchrun --standalone picks its own port).

- the fsdp rule against the JAX package's `_fsdp_spec`; the mesh's axes
  and each rank's batch slice; the ragged-batch replicate rule; the
  tensor-parallel plan's qkv reorder, its indivisible fall-back and its
  no-match guard;
- the host DataLoader and the device pipeline's loader sharded over 2
  ranks give the one-rank batch bit for bit (draws keyed by the global
  example index);
- `Reconstructor` data-parallel over 4 ranks at B=6 (padded to 8) against
  the plain one (1e-5), `DiffusionReconstructor` at B=4 (1e-5);
- `window_attention_sharded` on 2 ranks against the JAX package's on a
  2-device mesh, with the shared mask, the per-window mask and none
  (1e-5);
- `dryrun_multichip(2, "gloo")`; `torchrun -m dl_swin_gan_tpu_torch.train`
  with MODEL.STRATEGY fsdp and `scripts.reconstruct_h5 --data-parallel`
  against the one-process serving of the same checkpoint.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.convert import init_params
from dl_swin_gan_tpu_torch.data import DataLoader, InMemoryDataset
from dl_swin_gan_tpu_torch.data.device_pipeline import DevicePipelineLoader
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, quality_split,
)
from dl_swin_gan_tpu_torch.infer import Reconstructor
from dl_swin_gan_tpu_torch.infer.reconstruct import DiffusionReconstructor
from dl_swin_gan_tpu_torch.kernels.window_attn import (
    window_attention_sharded,
)
from dl_swin_gan_tpu_torch.models.dit import Attention, Mlp
from dl_swin_gan_tpu_torch.parallel import mesh as M
from dl_swin_gan_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ rules, no ranks

@pytest.mark.parametrize("shape,fsdp", [
    ((64, 96), 2), ((64, 96), 4), ((3, 3, 3, 16, 16), 2), ((10,), 2),
    ((7, 9, 11, 13), 2), ((256, 256), 1), ((48, 30), 8)])
def test_fsdp_rule_matches_jax(shape, fsdp):
    from dl_swin_gan_tpu.parallel.mesh import _fsdp_spec as jax_rule

    spec = tuple(jax_rule(shape, fsdp))
    want = spec.index("fsdp") if "fsdp" in spec else None
    assert M._fsdp_spec(shape, fsdp) == want


@pytest.mark.parametrize("heads,tp", [(4, 2), (8, 4), (6, 3)])
def test_qkv_reorder_gives_each_rank_its_heads(heads, tp):
    """(3, heads, head_dim) rows reordered so that rank r's contiguous
    third-of-a-tp-share holds q, k and v of heads r*H/tp .. (r+1)*H/tp."""
    hd = 2
    rows = torch.arange(3 * heads * hd)
    moved = M._heads_first(rows, heads, tp)
    per = 3 * heads * hd // tp
    for r in range(tp):
        mine = moved[r * per:(r + 1) * per].reshape(3, heads // tp, hd)
        for s in range(3):
            for j in range(heads // tp):
                h = r * heads // tp + j
                assert mine[s, j].tolist() == rows.reshape(3, heads, hd)[
                    s, h].tolist()
    assert torch.equal(M._heads_back(moved, heads, tp), rows)
    w = torch.randn(3 * heads * hd, 5)
    assert torch.equal(M._heads_back(M._heads_first(w, heads, tp), heads,
                                     tp), w)


def test_window_attention_sharded_needs_divisible_windows():
    class Mesh:
        shape = (3, 1, 1)

        def get_local_rank(self, axis):
            return 0

    q = torch.zeros(8, 2, 4, 4)
    with pytest.raises(ValueError, match="not divisible"):
        window_attention_sharded(q, q, q, torch.zeros(2, 4, 4), None, Mesh())


# ---------------------------------------------------------- the sharded loaders

def _cfg(**over):
    cfg = load_cfg(str(REPO / "configs/basic/example.yaml"), freeze=False)
    cfg.merge_from_list(["MODEL.PARAMETERS.NUM_UNROLLS", 1,
                         "MODEL.PARAMETERS.NUM_RESBLOCKS", 1,
                         "MODEL.PARAMETERS.NUM_FEATURES", 8,
                         "AUG_TRAIN.CROP_READOUT", 0,
                         "AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS", (3, 4),
                         "AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY", 0.0])
    for k, v in over.items():
        cfg.merge_from_list([k, v])
    return cfg


GEOMETRY = dict(slices=3, T=6, Y=16, X=16, C=3)


def _loader_batches(shard):
    cfg = _cfg()
    files = quality_split("train", 2, **GEOMETRY)
    data = InMemoryDataset(files, CinePreprocess(cfg, draw_seed=7))
    loader = DataLoader(data, batch_size=2, shuffle=True, seed=3,
                        num_workers=1, shard=shard)
    return [b for _ in range(2) for b in loader]


def test_data_loader_shards_make_the_one_rank_batch():
    whole = _loader_batches((0, 1))
    parts = [_loader_batches((r, 2)) for r in range(2)]
    assert len(whole) == len(parts[0]) == 6
    for i, batch in enumerate(whole):
        for key, value in batch.items():
            np.testing.assert_array_equal(
                np.concatenate([parts[r][i][key] for r in range(2)]), value,
                err_msg=key)
        assert isinstance(parts[0][i], M.RankBatch)


def _pipeline_batches(shard):
    cfg = _cfg()
    files = quality_split("train", 2, **GEOMETRY)
    loader = DevicePipelineLoader(None, cfg, seed=3, files=files,
                                  device="cpu", draw_seed=7, shard=shard)
    return [b for _ in range(2) for b in loader]


def test_device_pipeline_shards_make_the_one_rank_batches():
    whole = _pipeline_batches((0, 1))
    parts = [_pipeline_batches((r, 2)) for r in range(2)]
    assert len(whole) == 12 and len(parts[0]) == 6
    for i, batch in enumerate(whole):
        part = parts[i % 2][i // 2]
        for key, value in batch.items():
            torch.testing.assert_close(part[key], value, rtol=0, atol=0,
                                       msg=key)


# ------------------------------------------------------------------ the mesh

def _rank_mesh(rank, device):
    out = {}
    for shape in ((2, 2, 1), (1, 2, 2), (4, 1, 1), (-1, 1, 2)):
        mesh = M.make_mesh(*shape)
        batch = {"x": np.arange(8)}
        out[shape] = (tuple(mesh.shape), M.batch_shard(mesh),
                      M.shard_batch(batch, mesh)["x"].tolist(),
                      M.shard_batch_or_replicate({"x": np.arange(6)},
                                                 mesh)[1])
    try:
        M.make_mesh(3, 1, 1)
        out["cover"] = None
    except ValueError as e:
        out["cover"] = str(e)
    mesh = M.make_mesh(1, 1, 4)
    try:
        M.apply_tp(torch.nn.Sequential(torch.nn.Linear(4, 4)), mesh)
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    g = torch.Generator().manual_seed(0)
    model = torch.nn.ModuleDict({"attn": Attention(12, 3, g),
                                 "mlp": Mlp(12, 24, 12, generator=g)})
    M.apply_tp(model, M.make_mesh(2, 1, 2))
    out["fallback"] = (model.tp_modules, type(model["attn"].qkv.weight)
                       .__name__, type(model["mlp"].fc1.weight).__name__)
    out["sampler"] = [x.clone() for x in _sampler_update(
        *_sampler_draws(rank), group=torch.distributed.group.WORLD)]
    return out


def _sampler_draws(rank):
    """Rank `rank`'s timesteps and losses of one step."""
    g = torch.Generator().manual_seed(rank)
    return torch.randint(0, 8, (3,), generator=g), torch.rand(3, generator=g)


def _sampler_update(ts, losses, group=None):
    from dl_swin_gan_tpu_torch.diffusion import create_diffusion
    from dl_swin_gan_tpu_torch.diffusion.timestep_sampler import (
        LossSecondMomentResampler,
    )

    sampler = LossSecondMomentResampler(
        create_diffusion(timestep_respacing="", diffusion_steps=8), 2)
    state = sampler.init_state()
    for _ in range(2):
        state = sampler.update_with_losses(state, ts, losses, group)
    return state


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return run_ranks(_rank_mesh, 4, "gloo",
                     directory=str(tmp_path_factory.mktemp("mesh")))


def test_mesh_axes_and_batch_slices(mesh_ranks):
    for rank, out in enumerate(mesh_ranks):
        assert out[(2, 2, 1)][:3] == ((2, 2, 1), (rank, 4),
                                      [2 * rank, 2 * rank + 1])
        # (1, 2, 2): ranks 2i, 2i+1 share a slice (model axis)
        assert out[(1, 2, 2)][:3] == ((1, 2, 2), (rank // 2, 2),
                                      list(range(4 * (rank // 2),
                                                 4 * (rank // 2) + 4)))
        assert out[(4, 1, 1)][1] == (rank, 4)
        assert out[(-1, 1, 2)][0] == (2, 1, 2)


def test_ragged_batches_replicate(mesh_ranks):
    """6 examples over 4 batch ranks replicate; over 2 they split."""
    for out in mesh_ranks:
        assert out[(2, 2, 1)][3] is False and out[(4, 1, 1)][3] is False
        assert out[(1, 2, 2)][3] is True


def test_mesh_must_cover_every_rank(mesh_ranks):
    assert "does not cover the 4 ranks" in mesh_ranks[0]["cover"]


def test_tp_guard_raises_when_nothing_matches(mesh_ranks):
    assert "no module matched" in mesh_ranks[0]["guard"]


def test_tp_falls_back_on_indivisible_heads(mesh_ranks):
    """3 heads do not split over 2 ranks: the attention stays whole (plain
    parameters), the MLP (24 hidden) is split."""
    matched, qkv_type, fc1_type = mesh_ranks[0]["fallback"]
    assert matched == ["mlp"]
    assert (qkv_type, fc1_type) == ("Parameter", "DTensor")


def test_loss_aware_sampler_history_is_the_global_one(mesh_ranks):
    """Every rank's (t, loss) pairs go into every rank's history, in rank
    order: the one-process update with all four ranks' draws."""
    draws = [_sampler_draws(r) for r in range(4)]
    ref = _sampler_update(torch.cat([d[0] for d in draws]),
                          torch.cat([d[1] for d in draws]))
    for out in mesh_ranks:
        for got, want in zip(out["sampler"], ref):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------ data-parallel serving

def _recon_cfg(kind):
    if kind == "res":
        cfg = _cfg(**{"MODEL.PARAMETERS.FIX_STEP_SIZE": True})
    else:
        cfg = get_cfg()
        cfg.MODEL.MODEL_TYPE = "DIT"
        cfg.MODEL.META_ARCHITECTURE = "DDPM_X"
        p = cfg.MODEL.PARAMETERS
        p.NUM_UNROLLS, p.NUM_LAYERS, p.NUM_HEADS = 1, 1, 2
        p.NUM_FEATURES, p.NUM_RESBLOCKS = 24, 0
        cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (3, 4)
        cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.freeze()
    return cfg


def _recon_batch(cfg, B):
    pre = CinePreprocess(cfg, use_seed=True)
    ex = [pre(*make_cine_example(T=6, Y=16, X=16, C=3, E=2, seed=i),
              f"dp_{i}") for i in range(B)]
    return {k: np.stack([e[k] for e in ex]) for k in
            ("kspace", "maps", "mask", "init_image", "scale")}


def _recon(kind, B, mesh=None):
    cfg = _recon_cfg(kind)
    params = init_params(cfg, 0)
    if kind == "res":
        return Reconstructor(cfg, params, device="cpu",
                             mesh=mesh)(_recon_batch(cfg, B))
    return DiffusionReconstructor(cfg, params, sample_steps=2,
                                  device="cpu", mesh=mesh)(
        _recon_batch(cfg, B))


def _rank_recon(rank, device):
    mesh = M.make_mesh()
    return {"res": _recon("res", 6, mesh), "dit": _recon("dit", 4, mesh)}


@pytest.fixture(scope="module")
def recon_ranks(tmp_path_factory):
    return run_ranks(_rank_recon, 4, "gloo",
                     directory=str(tmp_path_factory.mktemp("recon")))


@pytest.mark.parametrize("kind,B", [("res", 6), ("dit", 4)])
def test_data_parallel_recon_matches_plain(recon_ranks, kind, B):
    plain = _recon(kind, B)
    for out in recon_ranks:                 # every rank holds the whole batch
        assert out[kind].shape == plain.shape and plain.shape[0] == B
        np.testing.assert_allclose(out[kind], plain, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- context-parallel attention

def _attention_data(W, nW, H=2, N=16, D=8, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((W, H, N, D)).astype(np.float32)
               for _ in range(3))
    bias = 0.1 * rng.standard_normal((H, N, N)).astype(np.float32)
    mask = np.where(rng.rand(nW, N, N) < 0.3, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


CASES = [(8, 2, True), (8, 8, True), (8, 2, False)]   # shared, per-window


def _rank_attention(rank, device):
    mesh = M.make_mesh(2, 1, 1)
    out = []
    for W, nW, masked in CASES:
        q, k, v, bias, mask = map(torch.from_numpy, _attention_data(W, nW))
        out.append(window_attention_sharded(q, k, v, bias,
                                            mask if masked else None,
                                            mesh).numpy())
    return out


def test_window_attention_sharded_matches_jax(tmp_path):
    import jax

    from dl_swin_gan_tpu.kernels.window_attn import (
        window_attention_sharded as jax_sharded,
    )
    from dl_swin_gan_tpu.parallel.mesh import make_mesh as jax_mesh

    ranks = run_ranks(_rank_attention, 2, "gloo", directory=str(tmp_path))
    mesh = jax_mesh(data=2, fsdp=1, devices=jax.devices()[:2])
    for i, (W, nW, masked) in enumerate(CASES):
        q, k, v, bias, mask = _attention_data(W, nW)
        ref = np.asarray(jax_sharded(q, k, v, bias, mask if masked else None,
                                     mesh))
        ours = np.concatenate([r[i] for r in ranks])
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"W={W} nW={nW} mask={masked}")


# -------------------------------------------------------- dry run, torchrun

def test_dryrun_multichip_on_two_ranks():
    from dl_swin_gan_tpu_torch.entry import dryrun_multichip

    losses = dryrun_multichip(2, "gloo")
    assert set(losses) == {"unrolled", "diffusion", "gan", "dslr"}
    assert all(np.isfinite(v) for v in losses.values())


def _torchrun(args, cwd):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", *args]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_torchrun_training_and_data_parallel_serving(tmp_path):
    """torchrun trains with STRATEGY fsdp (rank 0 writes the metrics and a
    checkpoint in the one-process format), and reconstruct_h5
    --data-parallel serves it as the one-process script does."""
    import json

    from dl_swin_gan_tpu_torch.data.synthetic import write_synthetic_dataset

    for split, seed in (("train", 0), ("val", 100)):
        write_synthetic_dataset(str(tmp_path / "data" / split), num_files=2,
                                slices=2, T=6, Y=32, X=16, C=3, seed=seed)
    overrides = ["MODEL.PARAMETERS.NUM_UNROLLS", "1",
                 "MODEL.PARAMETERS.NUM_RESBLOCKS", "1",
                 "MODEL.PARAMETERS.NUM_FEATURES", "8",
                 "AUG_TRAIN.CROP_READOUT", "0", "AUG_VAL.CROP_READOUT", "0",
                 "AUG_VAL.UNDERSAMPLE.ACCELERATIONS", "(3, 4)",
                 "MODEL.STRATEGY", "fsdp",
                 "DATALOADER.TRAIN_BATCH_SIZE", "2",
                 "DATALOADER.NUM_WORKERS", "1",
                 "LOGGER.LOG_METRICS_EVERY_N_STEPS", "1",
                 "DATASET.TRAIN", f"('{tmp_path / 'data' / 'train'}',)",
                 "DATASET.VAL", f"('{tmp_path / 'data' / 'val'}',)",
                 "OUTPUT_DIR", str(tmp_path / "run")]
    config = str(REPO / "configs/basic/example.yaml")
    _torchrun(["-m", "dl_swin_gan_tpu_torch.train", "--config-file", config,
               "--max-epochs", "1", "--device", "cpu", *overrides], REPO)
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        steps = [json.loads(line) for line in f]
    assert [r["step"] for r in steps if "Train/complex_l1" in r] == [1, 2]
    ckpt = str(tmp_path / "run" / "checkpoints")
    h5 = str(next((tmp_path / "data" / "val").glob("*.h5")))
    serve = ["--config-file", config, "--ckpt", ckpt, "--file", h5,
             "--acceleration", "4", "--batch-size", "2", "--device", "cpu",
             *overrides[:10]]
    _torchrun(["-m", "dl_swin_gan_tpu_torch.scripts.reconstruct_h5",
               "--data-parallel", "--out-directory", str(tmp_path / "dp"),
               *serve], REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "dl_swin_gan_tpu_torch.scripts.reconstruct_h5",
         "--out-directory", str(tmp_path / "one"), *serve], cwd=REPO,
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    from dl_swin_gan_tpu_torch.data import cfl

    name = Path(h5).stem + "_4accel.im"
    one = cfl.read(str(tmp_path / "one" / name))
    dp = cfl.read(str(tmp_path / "dp" / name))
    np.testing.assert_allclose(dp, one, rtol=1e-5, atol=1e-6)
