"""The port's trainers on a mesh against their one-rank steps, on the CPU
over gloo (`parallel/launch.py run_ranks`, a file:// rendezvous under the
test's tmp_path).

For each trainer (RES on example.yaml, hqs/MoDL, GAN, DSLR and the bf16
DiT on dit_bf16.yaml, all at toy widths) the same global batch of one
example per rank and the same seeded init go through two train steps on
one process (no mesh) and on the mesh: at world size 2 the mesh that
MODEL.STRATEGY fsdp makes (1 x 2 x 1: every parameter sharded over both
ranks), at world size 4 data 2 x fsdp 2 (HSDP). The first step's
gradients (gathered whole) are held to 1e-5 rel L2 (float32; the bf16 DiT
to 1e-2, since each rank rounds its half of a weight gradient's sum to
bfloat16 before the average), and both steps' metrics to 2e-3 as JAX
tests/test_sharded_trainers.py holds them. The hqs case fails with a
local zdot: its CG step sizes are inner products over the whole batch.

A checkpoint saved at world size 2 restores at world size 1 and the other
way round, in the single-device format. The DiT (DDPM_X) fed by its own
draw-seeded host loader: the two ranks' slices of the first batch, their
90/10 submasks included, make the one-rank batch bit for bit, and the step
on them matches the one-rank step.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, quality_split,
)
from dl_swin_gan_tpu_torch.parallel.launch import run_ranks
from dl_swin_gan_tpu_torch.parallel.mesh import full_tensor, make_mesh
from dl_swin_gan_tpu_torch.train import (
    CheckpointManager, DiffusionTrainer, DSLRTrainer, GANTrainer, Trainer,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
T, Y, X, C, E = 6, 16, 16, 3, 2
GRAD_REL_L2 = {"res": 1e-5, "hqs": 1e-5, "gan": 1e-5, "dslr": 1e-5,
               "dit_bf16": 1e-2}
METRIC_RTOL = 2e-3
KINDS = tuple(GRAD_REL_L2)


def case_cfg(kind):
    """The toy config of a case: its YAML at toy widths."""
    toy = ["MODEL.PARAMETERS.NUM_UNROLLS", 2,
           "MODEL.PARAMETERS.NUM_RESBLOCKS", 1,
           "MODEL.PARAMETERS.NUM_FEATURES", 8,
           "AUG_TRAIN.CROP_READOUT", 0,
           "AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS", (3, 4),
           "AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY", 0.0,
           "OPTIMIZER.ADAM.LR", 1e-3, "SEED", 5]
    yaml, extra = {
        "res": ("configs/basic/example.yaml", []),
        "hqs": ("configs/basic/example.yaml",
                ["MODEL.META_ARCHITECTURE", "modl",
                 "MODEL.PARAMETERS.MODL.NUM_CG_STEPS", 3]),
        "gan": ("configs/basic/example.yaml",
                ["MODEL.GAN.DISC_FEATURES", 4, "MODEL.GAN.DISC_LAYERS", 2,
                 "MODEL.GAN.ADV_WEIGHT", 0.5]),
        "dslr": ("configs/config_dslr.yaml",
                 ["MODEL.PARAMETERS.DSLR.BLOCK_SIZE", 8,
                  "MODEL.PARAMETERS.DSLR.NUM_BASIS", 3,
                  "MODEL.PARAMETERS.DSLR.NUM_CG_STEPS", 3]),
        "dit_bf16": ("configs/quality/dit_bf16.yaml",
                     ["MODEL.PARAMETERS.NUM_LAYERS", 2,
                      "MODEL.PARAMETERS.NUM_FEATURES", 32,
                      "MODEL.PARAMETERS.NUM_HEADS", 4,
                      "DATALOADER.DEVICE_PIPELINE", False]),
    }[kind]
    cfg = load_cfg(str(REPO / yaml), freeze=False)
    cfg.merge_from_list(toy + extra)
    cfg.MODEL.PARAMETERS.NUM_EMAPS = E
    return cfg


TRAINERS = {"res": Trainer, "hqs": Trainer, "gan": GANTrainer,
            "dslr": DSLRTrainer, "dit_bf16": DiffusionTrainer}


def case_batch(kind, cfg, B):
    """A global batch of B preprocessed synthetic slices."""
    pre = CinePreprocess(cfg, use_seed=True, lr_decom=kind == "dslr")
    examples = [pre(*make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=i),
                    f"shard_{i}") for i in range(B)]
    return {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}


def two_steps(kind, B, mesh=None, device="cpu"):
    """(metrics of both steps, the first step's gradients gathered whole,
    trainer, state): two train steps on the same global batch."""
    cfg = case_cfg(kind)
    trainer = TRAINERS[kind](cfg, device=device, mesh=mesh)
    state = trainer.init_state(seed=3)
    batch = case_batch(kind, cfg, B)
    metrics, grads = [], None
    for step in range(2):
        m = trainer.train_step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if step == 0:
            grads = {n: full_tensor(p.grad).detach().cpu().numpy()
                     for n, p in state.model.named_parameters()
                     if p.grad is not None}
    return metrics, grads, trainer, state


def loader_step(mesh=None):
    """The dit_bf16 case (DDPM_X) fed by its trainer's host loader, draws
    seeded from (7, k): the first batch as the step gets it (this rank's
    slice under a mesh), and the step's metrics."""
    cfg = case_cfg("dit_bf16")
    cfg.DATALOADER.TRAIN_BATCH_SIZE = 2
    trainer = DiffusionTrainer(cfg, device="cpu", mesh=mesh, draw_seed=7)
    files = quality_split("train", 1, slices=2, T=T, Y=Y, X=X, C=C, E=E)
    for batch in trainer._train_loader(None, train_data=files):
        break
    batch = trainer.prepare_batch(batch)
    state = trainer.init_state(seed=3)
    metrics = trainer.train_step(state, batch)
    return ({k: np.asarray(v) for k, v in batch.items()},
            {k: float(v) for k, v in metrics.items()})


def _rank_cases(rank, device, shape, kinds, ckpt_in, ckpt_out):
    """Every case on a mesh of `shape` (None: the one STRATEGY fsdp makes);
    rank 0 returns the results, every rank its `loader_step` at world 2.
    Also restores the one-rank checkpoint `ckpt_in` and saves a sharded one
    to `ckpt_out`."""
    out = {}
    if shape is None:
        out["loader"] = loader_step(make_mesh(1, 2, 1))
    for kind in kinds:
        mesh = None if shape is None else make_mesh(*shape)
        if shape is None:
            cfg = case_cfg(kind)
            cfg.MODEL.STRATEGY = "fsdp"
            trainer = TRAINERS[kind](cfg, device="cpu")
            assert tuple(trainer.mesh.shape) == (1, 2, 1)
            mesh = trainer.mesh
        metrics, grads, trainer, state = two_steps(kind, mesh.size(), mesh)
        out[kind] = (metrics, grads)
        if kind == "dit_bf16" and ckpt_out:
            # the EMA gathered whole into the checkpoint and laid out again
            # as the sharded parameters on restore
            CheckpointManager(ckpt_out + "_ema").save(state.step, state)
            restored = trainer.init_state(seed=11)
            CheckpointManager(ckpt_out + "_ema").restore(restored)
            out["ema"] = {n: (full_tensor(restored.ema[n]).float().numpy(),
                              full_tensor(v).float().numpy())
                          for n, v in state.ema.items()}
        if kind == "res" and ckpt_out:
            CheckpointManager(ckpt_out).save(state.step, state)
            restored = trainer.init_state(seed=11)
            CheckpointManager(ckpt_in).restore(restored)
            out["restored"] = {
                "step": restored.step,
                "model": {n: full_tensor(p).detach().numpy()
                          for n, p in restored.model.named_parameters()},
                "exp_avg": {n: full_tensor(restored.optimizer.state[p][
                    "exp_avg"]).numpy() for n, p in
                    restored.model.named_parameters()
                    if "exp_avg" in restored.optimizer.state[p]}}
    return out if rank == 0 else {"loader": out.get("loader")}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def one_rank():
    """The one-process steps of every case at B = 2 and 4."""
    return {(kind, B): two_steps(kind, B) for kind in KINDS for B in (2, 4)}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, one_rank):
    """{world: rank 0's results} at world 2 (STRATEGY fsdp) and 4 (2 x 2),
    with the checkpoint exchange at world 2."""
    tmp = tmp_path_factory.mktemp("sharded")
    _, _, trainer, state = one_rank[("res", 2)]
    CheckpointManager(str(tmp / "one")).save(state.step, state)
    two = run_ranks(_rank_cases, 2, "gloo", None, KINDS, str(tmp / "one"),
                    str(tmp / "two"), directory=str(tmp))
    out = {2: two[0],
           4: run_ranks(_rank_cases, 4, "gloo", (2, 2, 1), KINDS, None, None,
                        directory=str(tmp))[0]}
    out["loader"] = [r["loader"] for r in two]
    out["dirs"] = tmp
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_matches_one_rank(one_rank, sharded, kind, world):
    ref_metrics, ref_grads, _, _ = one_rank[(kind, world)]
    metrics, grads = sharded[world][kind]
    assert set(grads) == set(ref_grads) and grads
    for name, g in ref_grads.items():
        assert _rel_l2(grads[name], g) <= GRAD_REL_L2[kind], name
    for step, (m, ref) in enumerate(zip(metrics, ref_metrics)):
        assert set(m) == set(ref)
        for key in ref:
            np.testing.assert_allclose(m[key], ref[key], rtol=METRIC_RTOL,
                                       atol=1e-6, err_msg=f"{key} step {step}")


def test_hqs_needs_the_global_inner_products(one_rank):
    """The hqs CG couples the slices of a batch: each slice alone takes
    other step sizes, so a rank-local zdot could not match the one-rank
    step."""
    cfg = case_cfg("hqs")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(seed=3)
    batch = case_batch("hqs", cfg, 2)
    whole = trainer.val_step(state, batch)[1]
    halves = torch.cat([trainer.val_step(state, {
        k: v[i:i + 1] for k, v in batch.items()})[1] for i in range(2)])
    assert _rel_l2(halves.numpy(), whole.numpy()) > 1e-4


def test_sharded_ema_round_trips_through_a_checkpoint(one_rank, sharded):
    """The DiT's EMA (the DiffusionTrainer keeps one) saved whole at world 2
    and restored into the sharded state equals the state's, for every
    parameter of the one-process model."""
    ema = sharded[2]["ema"]
    _, _, _, state = one_rank[("dit_bf16", 2)]
    assert set(ema) == set(state.ema)
    for name, (restored, saved) in ema.items():
        assert restored.shape == tuple(state.ema[name].shape), name
        np.testing.assert_array_equal(restored, saved, err_msg=name)


def test_checkpoint_restores_across_world_sizes(one_rank, sharded):
    """Saved at world 2 (STRATEGY fsdp) it loads into a one-process state as
    the one-process run's own checkpoint would; the one-process checkpoint
    restored at world 2 gives back its weights and Adam moments."""
    _, _, trainer, state = one_rank[("res", 2)]
    tmp = sharded["dirs"]
    restored = trainer.init_state(seed=11)
    CheckpointManager(str(tmp / "two")).restore(restored)
    assert restored.step == 2
    ref = dict(state.model.named_parameters())
    for name, p in restored.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    payload = torch.load(next((tmp / "two").glob("step_*.pt")),
                         weights_only=True)
    assert set(payload) == {"step", "model", "optimizer", "ema"}
    assert isinstance(next(iter(payload["optimizer"]["state"])), int)
    back = sharded[2]["restored"]
    assert back["step"] == 2
    moments = {n: state.optimizer.state[p]["exp_avg"].numpy()
               for n, p in state.model.named_parameters()
               if "exp_avg" in state.optimizer.state[p]}
    assert moments and set(moments) <= set(back["exp_avg"])
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(back["model"][name],
                                      p.detach().numpy())
    for name, m in moments.items():
        np.testing.assert_array_equal(back["exp_avg"][name], m)


def test_sharded_host_loader_makes_the_one_rank_step(sharded):
    """DDPM_X through the draw-seeded host loader at world 2: the ranks'
    slices (a RankBatch each) make the one-rank batch bit for bit, the
    submasks drawn per example included, and the steps' metrics agree."""
    whole, ref = loader_step()
    parts = [batch for batch, _ in sharded["loader"]]
    assert set(parts[0]) == set(whole) and "mask_r" in whole
    assert len(whole["mask_r"]) == 2
    for key, value in whole.items():
        np.testing.assert_array_equal(
            np.concatenate([p[key] for p in parts]), value, err_msg=key)
    assert not np.array_equal(parts[0]["mask_r"], parts[1]["mask_r"])
    metrics = sharded["loader"][0][1]
    assert set(metrics) == set(ref)
    for key in ref:
        np.testing.assert_allclose(metrics[key], ref[key], rtol=METRIC_RTOL,
                                   atol=1e-6, err_msg=key)
