"""The torch port's complex convs (ComplexConv) and the 1D/2D/3D complex
ResNets, against flax on weights converted by `flax_to_torch`: outputs and
parameter gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.models import layers as jlayers
from dl_swin_gan_tpu.models import resnet as jresnet
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.models import layers, resnet

torch.set_num_threads(1)



def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _strip(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------- complex convs

def _flax_grads(module, params, x, weight):
    """(output, d loss / d params) of loss = sum |out * weight|^2 in JAX."""
    def loss(p):
        out = module.apply({"params": p}, x)
        return jnp.sum(jnp.abs(out * weight) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def _torch_grads(net, x, weight):
    out = net(torch.from_numpy(x))
    torch.sum(torch.abs(out * torch.from_numpy(weight)) ** 2).backward()
    return out.detach().numpy(), {n: p.grad.numpy()
                                  for n, p in net.named_parameters()}


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_complex_conv_matches_flax(ndim):
    """One ComplexConv (inside a ConvBlock, ReLU on re and im apart) on
    weights converted by flax_to_torch: output and parameter gradients to
    rel 1e-5."""
    rng = np.random.RandomState(ndim)
    spatial = (5, 6, 4)[:ndim]
    x = _c64(rng, 2, *spatial, 3)                          # channels-last
    jblock = jlayers.ConvBlock(5, (3,) * ndim, "relu", is_complex=True)
    params = jax.jit(jblock.init)(jax.random.PRNGKey(0), x)["params"]
    weight = _c64(rng, 2, *spatial, 5)
    ref, jgrads = _flax_grads(jblock, params, x, weight)

    block = layers.ConvBlock(3, 5, 3, "relu", is_complex=True, ndim=ndim)
    block.load_state_dict(_strip(flax_to_torch(
        {"ResNet1D_0": {"ConvBlock_0": params}}), "temporal.0.head."))
    out, grads = _torch_grads(block, np.moveaxis(x, -1, 1),
                              np.moveaxis(weight, -1, 1))
    assert _rel(out, np.moveaxis(ref, -1, 1)) <= 1e-5
    want = _strip(flax_to_torch({"ResNet1D_0": {"ConvBlock_0": jgrads}}),
                  "temporal.0.head.")
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g, want[name].numpy()) <= 1e-5, name


_RESNETS = {1: (jresnet.ResNet1D, resnet.ResNet1D, "ResNet1D_0", (8,)),
            2: (jresnet.ResNet2D, resnet.ResNet2D, "ResNet2D_0", (6, 6)),
            3: (jresnet.ResNet3D, resnet.ResNet3D, "ResNet3D_0", (4, 6, 5))}


@pytest.mark.parametrize("ndim,circular", [(1, True), (2, False), (3, True)])
def test_complex_resnet_matches_flax(ndim, circular):
    """ResNet1D/2D/3D with complex convs (46 channels at F=64 here 12 at
    F=16; the residual is x, not act(x)), circular padding on the first
    spatial axis: output and parameter gradients to rel 1e-5."""
    JaxNet, Net, name, spatial = _RESNETS[ndim]
    rng = np.random.RandomState(10 + ndim)
    x = _c64(rng, 2, 3, *spatial)                          # [N, C, *spatial]
    jnet = JaxNet(num_resblocks=2, num_features=16, use_complex_layers=True,
                  circular_pad=circular)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1), x)["params"]
    weight = _c64(rng, *x.shape)
    ref, jgrads = _flax_grads(jnet, params, x, weight)

    net = Net(num_resblocks=2, num_emaps=3, num_features=16,
              use_complex_layers=True, circular_pad=circular)
    assert net.head.conv.kernel_re.shape[0] == int(16 / 1.4142) + 1
    prefix = {"ResNet1D_0": "temporal.0.", "ResNet2D_0": "spatial.0.",
              "ResNet3D_0": "nets.0."}[name]
    net.load_state_dict(_strip(flax_to_torch({name: params}), prefix))
    out, grads = _torch_grads(net, x, weight)
    assert _rel(out, ref) <= 1e-5
    want = _strip(flax_to_torch({name: jgrads}), prefix)
    assert set(grads) == set(want)
    for key, g in grads.items():
        assert _rel(g, want[key].numpy()) <= 1e-5, key


def test_flax_to_torch_unrolled_lr_names():
    tree = {"ResNet2D_1": {"ConvBlock_0": {"ComplexConv_0": {
        "kernel_re": np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(
            2, 2, 3, 4), "kernel_im": np.zeros((2, 2, 3, 4), np.float32),
        "bias_re": np.zeros(4, np.float32),
        "bias_im": np.ones(4, np.float32)}}},
        "lambda_l": np.array([0.5], np.float32)}
    state = flax_to_torch(tree)
    assert set(state) == {"spatial.1.head.conv.kernel_re",
                          "spatial.1.head.conv.kernel_im",
                          "spatial.1.head.conv.bias_re",
                          "spatial.1.head.conv.bias_im", "lambda_l"}
    k = state["spatial.1.head.conv.kernel_re"]
    # torch weight[o, i, ky, kx] == flax kernel[ky, kx, i, o]
    assert k.shape == (4, 3, 2, 2) and k[3, 1, 0, 1] == tree[
        "ResNet2D_1"]["ConvBlock_0"]["ComplexConv_0"]["kernel_re"][0, 1, 1, 3]
    assert state["lambda_l"].tolist() == [0.5]
