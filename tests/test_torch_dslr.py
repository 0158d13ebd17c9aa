"""The torch port's DSLR solver (`UnrolledLR`) against the JAX package on
converted weights, in each ported mode: outputs and the gradients of every
parameter; the seeded init and the config."""

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
from dl_swin_gan_tpu_torch.solvers.dslr import UnrolledLR
from dl_swin_gan_tpu_torch.utils.headline import dslr_cfg

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


_MODES = ("dslr-cg-v1", "dslr-cg-v2", "dslr-cg-jacobi", "modslr-v1",
          "modslr-v2")


def _solver_kw(mode):
    return dict(mode=mode, num_unrolls=2, num_resblocks=1, num_features=8,
                num_emaps=_E, num_basis=_R, block_size=_B, num_cg_steps=3)


@pytest.mark.parametrize("mode", _MODES)
def test_unrolled_lr_matches_jax(dslr_problem, mode):
    """2 unrolls, 3 CG steps, converted weights: output to rel L2 1e-4,
    the gradients of a loss in every parameter to rel L2 1e-3 (the CG
    chains amplify float32 rounding)."""
    y, maps, mask, L0, R0 = dslr_problem
    target = _c64(np.random.RandomState(1), 1, _E, _T, _Y, _X)
    jop = JaxBlockOp(_B, (1, _E, _T, _Y, _X))
    jmodel = JaxUnrolledLR(**_solver_kw(mode))
    params = jax.jit(lambda k: jmodel.init(k, y, maps, mask, L0, R0, jop))(
        jax.random.PRNGKey(0))["params"]

    def jloss(p):
        out = jmodel.apply({"params": p}, y, maps, mask, L0, R0, jop)
        return jnp.mean(jnp.abs(out - target)), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model = UnrolledLR(**_solver_kw(mode))
    model.load_state_dict(flax_to_torch(params))
    out = model(*(torch.from_numpy(a) for a in (y, maps, mask, L0, R0)),
                BlockOp(_B, (1, _E, _T, _Y, _X)))
    assert _rel(out.detach().numpy(), np.asarray(ref)) <= 1e-4
    torch.mean(torch.abs(out - torch.from_numpy(target))).backward()
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name].numpy()) <= 1e-3, name


def test_dslr_pgd_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        UnrolledLR(**_solver_kw("dslr-pgd"))


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
