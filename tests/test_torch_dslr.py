"""The torch port's DSLR solver (`UnrolledLR`) against the JAX package on
converted weights, in each mode and with the RNN temporal nets: outputs and
the gradients of every parameter; the seeded init and the config. The
solver's flags are in `test_torch_dslr_flags.py`."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.ops.llr import BlockOp as JaxBlockOp
from dl_swin_gan_tpu.ops.llr import decompose as jax_decompose
from dl_swin_gan_tpu.solvers.dslr import UnrolledLR as JaxUnrolledLR
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch, init_params
from dl_swin_gan_tpu_torch.ops.llr import BlockOp
from dl_swin_gan_tpu_torch.solvers import build_model
from dl_swin_gan_tpu_torch.solvers.dslr import UnrolledLR, build_dslr_solver
from dl_swin_gan_tpu_torch.utils.headline import dslr_cfg
from tests.test_torch_gates import seeded_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- the solver

_E, _C, _T, _Y, _X, _B, _R = 2, 2, 4, 18, 12, 4, 3


@pytest.fixture(scope="module")
def dslr_problem():
    """y, maps, mask, L0, R0 of the toy geometry (E=2, C=2, T=4, 18x12,
    b=4, r=3), as numpy."""
    rng = np.random.RandomState(0)
    y = _c64(rng, 1, _C, _T, _Y, _X)
    maps = _c64(rng, 1, _E, _C, 1, _Y, _X)
    mask = (rng.rand(1, 1, _T, _Y, _X) < 0.5).astype(np.float32)
    op = JaxBlockOp(_B, (1, _E, _T, _Y, _X))
    L0, R0 = jax_decompose(jnp.asarray(_c64(rng, op.num_blocks,
                                            _E * _B * _B, _T)), _R)
    return (y * mask, maps, mask, np.array(L0), np.array(R0))


_MODES = ("dslr-pgd", "dslr-cg-v1", "dslr-cg-v2", "dslr-cg-jacobi",
          "modslr-v1", "modslr-v2")


def _solver_kw(mode, **flags):
    return {**dict(mode=mode, num_unrolls=2, num_resblocks=1,
                   num_features=8, num_emaps=_E, num_basis=_R, block_size=_B,
                   num_cg_steps=3), **flags}


def _jax_params(jmodel, mode, *args, block_op):
    """The JAX solver's weights drawn with numpy in the shapes of its init
    (`test_torch_gates.seeded_params`: tracing the init is far cheaper on
    the CPU than compiling it), the modslr lambdas at the JAX init's
    values (1.0 and 2.0 in modslr-v1, 5e-3 in modslr-v2), since a drawn
    penalty may be negative."""
    params = dict(seeded_params(jmodel, *args, block_op=block_op))
    for name, v in zip(("lambda_l", "lambda_r"),
                       (1.0, 2.0) if mode == "modslr-v1" else (5e-3, 5e-3)):
        if name in params:
            params[name] = np.full((1,), v, np.float32)
    return params


def _check_against_jax(problem, mode, **flags):
    """The solver on converted weights against the JAX package's: output to
    rel L2 1e-4, the gradients of a loss in every parameter to rel L2 1e-3
    (the CG chains and pgd's power method amplify float32 rounding)."""
    y, maps, mask, L0, R0 = problem
    target = _c64(np.random.RandomState(1), 1, _E, _T, _Y, _X)
    jop = JaxBlockOp(_B, (1, _E, _T, _Y, _X))
    jmodel = JaxUnrolledLR(**_solver_kw(mode, **flags))
    params = _jax_params(jmodel, mode, y, maps, mask, L0, R0, block_op=jop)

    def jloss(p):
        out = jmodel.apply({"params": p}, y, maps, mask, L0, R0, jop)
        return jnp.mean(jnp.abs(out - target)), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model = UnrolledLR(**_solver_kw(mode, **flags))
    model.load_state_dict(flax_to_torch(params))
    out = model(*(torch.from_numpy(a) for a in (y, maps, mask, L0, R0)),
                BlockOp(_B, (1, _E, _T, _Y, _X)))
    assert _rel(out.detach().numpy(), np.asarray(ref)) <= 1e-4
    torch.mean(torch.abs(out - torch.from_numpy(target))).backward()
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    # every trained parameter has a gradient (the RNN's input-side biases
    # are not trained; fix_step_size freezes the lambdas)
    assert set(grads) == {n for n, p in model.named_parameters()
                          if p.requires_grad and not (
                              flags.get("fix_step_size")
                              and n.startswith("lambda"))}
    assert set(grads) <= set(want)
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name].numpy()) <= 1e-3, name


@pytest.mark.parametrize("mode", _MODES)
def test_unrolled_lr_matches_jax(dslr_problem, mode):
    """2 unrolls, 3 CG steps (pgd: 2 gradient steps), converted weights."""
    _check_against_jax(dslr_problem, mode)


@pytest.mark.parametrize("mode", ("dslr-cg-v1", "dslr-pgd"))
def test_rnn_temporal_matches_jax(dslr_problem, mode):
    """use_rnn_temporal: the bidirectional 3-layer LSTM over t in place of
    the 1D ResNet, converted from the JAX package's RNN_{i} trees; one
    unroll (compiling the JAX LSTM's gradient dominates the case)."""
    _check_against_jax(dslr_problem, mode, use_rnn_temporal=True,
                       num_unrolls=1)


def test_build_dslr_solver_builds_pgd():
    """META_ARCHITECTURE dslr-pgd builds the pgd solver from a config, with
    the 1D ResNet temporal nets (no config reaches use_rnn_temporal)."""
    cfg = dslr_cfg()
    cfg.MODEL.META_ARCHITECTURE = "dslr-pgd"
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 2
    model = build_dslr_solver(cfg, torch.Generator().manual_seed(0))
    assert model.mode == "dslr-pgd" and not model.use_rnn_temporal
    assert len(model.temporal) == 2
    assert init_params(cfg, 0).keys() == model.state_dict().keys()


def test_fix_step_size_stops_the_lambda_gradients(dslr_problem):
    y, maps, mask, L0, R0 = dslr_problem
    model = UnrolledLR(**_solver_kw("modslr-v2"), fix_step_size=True)
    out = model(*(torch.from_numpy(a) for a in (y, maps, mask, L0, R0)),
                BlockOp(_B, (1, _E, _T, _Y, _X)))
    out.abs().mean().backward()
    assert model.lambda_l.grad is None and model.lambda_r.grad is None
    assert torch.equal(model.lambda_l, torch.full((1,), 5e-3))
    assert torch.equal(model.lambda_r, torch.full((1,), 5e-3))


def test_init_params_builds_the_dslr_solver():
    cfg = dslr_cfg()
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 2
    a, b = init_params(cfg, 0), init_params(cfg, 0)
    assert a.keys() == build_model(cfg).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["spatial.0.blocks.0.conv0.conv.kernel_re"]
    assert w.shape == (46, 46, 3, 3)         # int(64 / 1.4142) + 1 channels
    bound = 1.0 / np.sqrt(46 * 9)            # U(+-1/sqrt(fan_in))
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert a["temporal.1.head.conv.kernel_im"].shape == (46, 8, 3)
    assert a["spatial.1.tail.conv.bias_re"].shape == (16,)    # r * e


def test_dslr_cfg_matches_yaml():
    assert dslr_cfg() == load_cfg(str(REPO / "configs/config_dslr.yaml"))
