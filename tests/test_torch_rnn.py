"""The port's bidirectional LSTM (`models/rnn.py`) against the JAX
package's `models.rnn.RNN` on converted weights, the weight converters'
round trip, and the seeded init against flax's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.models.rnn import RNN as JaxRNN
from dl_swin_gan_tpu_torch.convert import (
    flax_to_torch, rnn_flax_to_torch, rnn_torch_to_flax, torch_to_flax,
)
from dl_swin_gan_tpu_torch.models.rnn import RNN
from dl_swin_gan_tpu_torch.solvers.dslr import UnrolledLR

torch.set_num_threads(1)

_N, _T, _C, _H = 6, 7, 3, 10
# lecun_normal's largest value times sqrt(fan_in): 2 / std of a unit normal
# truncated to [-2, 2]
_TRUNC = 2 / 0.87962566103423978


def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flax_params(num_layers, seed=0):
    x = jnp.zeros((_N, _T, _C), jnp.complex64)
    return JaxRNN(hidden_size=_H, num_layers=num_layers).init(
        jax.random.PRNGKey(seed), x)["params"]


@pytest.mark.parametrize("num_layers", (1, 3))
def test_rnn_matches_jax(num_layers):
    """Forward to rel L2 1e-5, the gradients of a loss in every weight to
    rel L2 1e-4; the input-side biases are not trained."""
    rng = np.random.RandomState(num_layers)
    x = _c64(rng, _N, _T, _C)
    target = _c64(rng, _N, _T, _C)
    jmodel = JaxRNN(hidden_size=_H, num_layers=num_layers)
    params = _flax_params(num_layers)

    def jloss(p):
        out = jmodel.apply({"params": p}, x)
        return jnp.mean(jnp.abs(out - target) ** 2), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model = RNN(_C, hidden_size=_H, num_layers=num_layers)
    model.load_state_dict(rnn_flax_to_torch(params))
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.complex64 and out.shape == (_N, _T, _C)
    assert _rel(out.detach().numpy(), np.asarray(ref)) <= 1e-5
    torch.mean(torch.abs(out - torch.from_numpy(target)) ** 2).backward()
    want = rnn_flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.requires_grad}
    assert set(grads) == {n for n in want if ".bias_ih_" not in n}
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name].numpy()) <= 1e-4, name


def test_rnn_converters_round_trip_bit_for_bit():
    params = jax.tree_util.tree_map(np.asarray, _flax_params(3, seed=1))
    back = rnn_torch_to_flax(rnn_flax_to_torch(params))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, leaf in flat:
        assert got[path].dtype == leaf.dtype
        assert np.array_equal(got[path], leaf), path
    # a DSLR solver with RNN temporal nets through the solver converters:
    # torch -> flax -> torch gives its state_dict back bit for bit
    solver = UnrolledLR(mode="dslr-pgd", num_unrolls=2, num_resblocks=1,
                        num_features=8, num_basis=3, block_size=4,
                        use_rnn_temporal=True,
                        generator=torch.Generator().manual_seed(0))
    state = solver.state_dict()
    tree = torch_to_flax(state, "RES")
    assert {"ResNet2D_0", "ResNet2D_1", "RNN_0", "RNN_1"} == set(tree)
    back = flax_to_torch(tree)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    with pytest.raises(KeyError):
        torch_to_flax({**state, "temporal.0.mystery": torch.zeros(1)}, "RES")


def test_rnn_seeded_init_matches_flax_distributions():
    """Shapes as flax's; the seeded draw is reproducible; the input kernels'
    and the Linear's scale is lecun-normal's (std 1/sqrt(fan_in), a unit
    normal truncated at +-2 and rescaled to unit variance), each gate's
    recurrent block orthogonal, the biases zero, as flax draws them."""
    a = RNN(8, hidden_size=64, generator=torch.Generator().manual_seed(0))
    b = RNN(8, hidden_size=64, generator=torch.Generator().manual_seed(0))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = jnp.zeros((2, 5, 8), jnp.complex64)
    shapes = jax.eval_shape(lambda: JaxRNN(hidden_size=64).init(
        jax.random.PRNGKey(0), x))["params"]
    ours = rnn_torch_to_flax(sa)
    assert (jax.tree_util.tree_map(lambda s: s.shape, shapes)
            == jax.tree_util.tree_map(np.shape, ours))
    flax_leaves = _flax_params(3)   # _H = 10: the same rules at a small width
    for name, cell in ours.items():
        if name == "Dense_0":
            k = cell["kernel"]
            assert np.abs(k).max() <= _TRUNC / np.sqrt(128) + 1e-6
            assert abs(k.std() * np.sqrt(128) - 1) < 0.1
            assert not cell["bias"].any()
            continue
        for gate in "ifgo":
            k = cell[f"i{gate}"]["kernel"]
            fan_in = k.shape[0]
            assert np.abs(k).max() <= _TRUNC / np.sqrt(fan_in) + 1e-6
            assert abs(k.std() * np.sqrt(fan_in) - 1) < 0.1
            h = cell[f"h{gate}"]
            np.testing.assert_allclose(h["kernel"].T @ h["kernel"],
                                       np.eye(64), atol=1e-5)
            assert not h["bias"].any()
    hk = np.asarray(flax_leaves["LSTMCell_0"]["hi"]["kernel"])
    np.testing.assert_allclose(hk.T @ hk, np.eye(_H), atol=1e-5)
