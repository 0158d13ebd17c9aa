"""Tensor parallelism of the transformer trunks (`parallel/mesh.py
apply_tp`) on the CPU over gloo: DiT (DiffusionTrainer, DDPM_X) and the
unrolled Swin (Trainer, config_swin.yaml with remat and stochastic depth
on) at toy widths, a model axis of 2 against one process.

Both ranks of the model axis take the whole batch; each holds half of the
heads of every attention (qkv and proj split Megatron-style, qkv's rows
reordered so that a rank holds q, k and v of its own heads) and half of
every MLP. The first train step's gradients, gathered whole and put back
in the unsplit qkv order, are held to 1e-5 rel L2 against the one-process
step's, the Swin relative-position bias table's included (each rank reads
its heads' columns; the table's gradient is summed over the model axis,
so a rank that kept only its own heads' gradient would fail here), and
both steps' losses and the validation output to 1e-5.
"""

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.parallel.launch import run_ranks
from dl_swin_gan_tpu_torch.parallel.mesh import (
    full_tensor, make_mesh, unpermute_qkv,
)
from dl_swin_gan_tpu_torch.train import DiffusionTrainer, Trainer
from dl_swin_gan_tpu_torch.utils.headline import swin_cfg

torch.set_num_threads(1)

T, Y, X, C, E = 8, 32, 32, 3, 2
REL_L2 = 1e-5


def case_cfg(kind):
    if kind == "swin":
        cfg = swin_cfg()
        p = cfg.MODEL.PARAMETERS
        p.NUM_UNROLLS, p.NUM_FEATURES = 1, 16
    else:
        from dl_swin_gan_tpu_torch.config import get_cfg

        cfg = get_cfg()
        cfg.MODEL.MODEL_TYPE = "DIT"
        cfg.MODEL.META_ARCHITECTURE = "DDPM_X"
        p = cfg.MODEL.PARAMETERS
        p.NUM_UNROLLS, p.NUM_LAYERS, p.NUM_FEATURES, p.NUM_HEADS = 1, 2, 32, 4
        p.NUM_EMAPS = E
        cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    cfg.AUG_TRAIN.CROP_READOUT = 0
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (3, 4)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.OPTIMIZER.ADAM.LR = 1e-3
    return cfg


def case_batch(cfg, B=2):
    pre = CinePreprocess(cfg, use_seed=True)
    examples = [pre(*make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=i),
                    f"tp_{i}") for i in range(B)]
    return {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}


def steps(kind, mesh=None):
    """(losses of two train steps, the first step's gradients whole in the
    unsplit layout, the validation output after them)."""
    cfg = case_cfg(kind)
    cls = Trainer if kind == "swin" else DiffusionTrainer
    trainer = cls(cfg, device="cpu", mesh=mesh)
    state = trainer.init_state(seed=3)
    batch = case_batch(cfg)
    key = "Train/complex_l1" if kind == "swin" else "Train MSE"
    losses, grads = [], None
    for step in range(2):
        losses.append(float(trainer.train_step(state, batch)[key]))
        if step == 0:
            grads = unpermute_qkv(state.model, {
                n: full_tensor(p.grad).detach() for n, p in
                state.model.named_parameters() if p.grad is not None})
    if kind == "swin":
        val = trainer.val_step(state, batch)[1]
    else:
        val = trainer.val_loss(state, trainer.prepare_batch(batch), 0)
    return (losses, {n: g.numpy() for n, g in grads.items()},
            val.detach().numpy(), list(getattr(state.model, "tp_modules",
                                               [])))


def _rank_tp(rank, device, kind):
    out = steps(kind, make_mesh(1, 1, 2))
    return out if rank == 0 else None


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


_RUNS = {}


def runs(kind, tmp_path_factory):
    """(kind, the one-process results, rank 0's at model=2), once a kind."""
    if kind not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"tp_{kind}")
        _RUNS[kind] = (kind, steps(kind), run_ranks(
            _rank_tp, 2, "gloo", kind, directory=str(tmp))[0])
    return _RUNS[kind]


@pytest.mark.parametrize("kind", ["dit", "swin"])
def test_tp_plan_split_every_attention_and_mlp(kind, tmp_path_factory):
    _, _, (_, _, _, matched) = runs(kind, tmp_path_factory)
    attn = [m for m in matched if m.endswith("attn")]
    mlp = [m for m in matched if m.endswith("mlp")]
    layers = 2 if kind == "dit" else 6      # DiT NUM_LAYERS; Swin depths
    assert len(attn) == len(mlp) == layers, matched


@pytest.mark.parametrize("kind", ["dit", "swin"])
def test_tp_gradients_match_one_process(kind, tmp_path_factory):
    _, (_, ref, _, _), (_, grads, _, _) = runs(kind, tmp_path_factory)
    assert set(grads) == set(ref)
    for name, g in ref.items():
        assert _rel(grads[name], g) <= REL_L2, name


@pytest.mark.parametrize("kind", ["dit", "swin"])
def test_tp_losses_and_output_match_one_process(kind, tmp_path_factory):
    _, (ref_losses, _, ref_val, _), (losses, _, val, _) = runs(
        kind, tmp_path_factory)
    np.testing.assert_allclose(losses, ref_losses, rtol=REL_L2)
    assert _rel(val, ref_val) <= REL_L2


def test_tp_swin_bias_table_gradient_covers_every_head(tmp_path_factory):
    _, (_, ref, _, _), (_, grads, _, _) = runs("swin", tmp_path_factory)
    tables = [n for n in ref if n.endswith("relative_position_bias_table")]
    assert len(tables) == 6
    for name in tables:
        heads = ref[name].shape[1]
        for half in (slice(0, heads // 2), slice(heads // 2, heads)):
            assert np.abs(ref[name][:, half]).max() > 0
            assert _rel(grads[name][:, half], ref[name][:, half]) <= REL_L2
