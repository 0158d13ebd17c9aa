"""Even conv kernels: the port's `Conv`, `ComplexConv` and `SeparableConv`
against the JAX package's at kernel 2 and 4, float32 and bfloat16. XLA's
SAME padding puts (k - 1) // 2 before and k // 2 after each axis, so an
even kernel pads one more after than before; the port pads explicitly.

The JAX side runs in a subprocess with XLA_FLAGS=
--xla_allow_excess_precision=false (tests/test_torch_bf16.py says why).
float32: rel L2 1e-5 (sums in other orders; a padding on the wrong side
moves the output by order 1). bfloat16: 2e-3, the bf16 RES trunk's limit
(both round the input, the kernel and the output at the same places).
"""

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu_torch.models.layers import (
    ComplexConv, Conv, SeparableConv,
)
from tests.test_torch_swin_bf16 import REPO, rel_l2, run_jax_bf16

torch.set_num_threads(1)

# (layer, kernel): a cubic kernel, one per axis with odd and even mixed,
# and the separable conv's (1, k, k) and (k, 1, 1) halves
CASES = [("conv", 2), ("conv", 4), ("conv", (1, 2, 3)), ("complex", 2),
         ("complex", 4), ("separable", 2), ("separable", 4)]
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
CIN, COUT, SIZE = 3, 5, (5, 6, 7)

_JAX_SIDE = """
import jax, jax.numpy as jnp, numpy as np
from dl_swin_gan_tpu.models.layers import ComplexConv, Conv, SeparableConv
d = dict(np.load({inp!r}))
out = {{}}
for i, (layer, k) in enumerate({cases!r}):
    k = (k,) * 3 if isinstance(k, int) else tuple(k)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(jnp, dtype)
        x = d[f"{{i}}/x"]
        if layer == "conv":
            m = Conv({cout}, k, dtype=dt)
        elif layer == "complex":
            m = ComplexConv({cout}, k, dtype=dt)
            x = x[..., :{cin}] + 1j * x[..., {cin}:]
        else:
            m = SeparableConv({cout}, k, "relu", dtype=dt)
        p = jax.eval_shape(m.init, jax.random.PRNGKey(0), x)["params"]
        params = jax.tree_util.tree_map_with_path(
            lambda path, s: d[f"{{i}}/" + "/".join(q.key for q in path)], p)
        y = np.asarray(jax.jit(m.apply)({{"params": params}}, x))
        out[f"{{i}}/{{dtype}}"] = y
np.savez({out!r}, **out)
"""


def _flax_kernel(w):
    """[Cout, Cin, *k] -> flax's [*k, Cin, Cout]."""
    return np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0))


def _layer(layer, k, dtype):
    g = torch.Generator().manual_seed(7)
    if layer == "conv":
        return Conv(CIN, COUT, k, g, dtype=dtype)
    if layer == "complex":
        return ComplexConv(CIN, COUT, k, g, dtype=dtype)
    return SeparableConv(CIN, COUT, k, "relu", g, dtype=dtype)


def _flax_params(layer, module):
    """The port layer's parameters as the flax module's tree, flattened to
    'path/leaf' keys."""
    def conv(c, name):
        return {f"{name}/kernel": _flax_kernel(c.weight.detach().numpy()),
                f"{name}/bias": c.bias.detach().numpy()}
    if layer == "conv":
        return conv(module, "Conv_0")
    if layer == "complex":
        return {k: (_flax_kernel(v.detach().numpy()) if "kernel" in k
                    else v.detach().numpy())
                for k, v in module.named_parameters()}
    return {**{f"Conv_0/{k}": v for k, v in conv(module.spatial,
                                                 "Conv_0").items()},
            **{f"Conv_1/{k}": v for k, v in conv(module.temporal,
                                                 "Conv_0").items()}}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("even")
    rng = np.random.RandomState(0)
    arrays = {}
    for i, (layer, k) in enumerate(CASES):
        chans = 2 * CIN if layer == "complex" else CIN
        arrays[f"{i}/x"] = rng.standard_normal((1, *SIZE, chans)).astype(
            np.float32)
        for key, v in _flax_params(layer, _layer(layer, k,
                                                 torch.float32)).items():
            arrays[f"{i}/{key}"] = v
    np.savez(tmp / "in.npz", **arrays)
    run_jax_bf16(_JAX_SIDE.format(inp=str(tmp / "in.npz"), cases=CASES,
                                  cin=CIN, cout=COUT,
                                  out=str(tmp / "jax.npz")))
    return arrays, dict(np.load(tmp / "jax.npz"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(CASES)), ids=[
    f"{layer}-k{k}" for layer, k in CASES])
def test_even_kernel_conv_matches_jax(jax_side, case, dtype):
    arrays, ref = jax_side
    layer, k = CASES[case]
    module = _layer(layer, k, getattr(torch, dtype))
    x = torch.from_numpy(arrays[f"{case}/x"]).permute(0, 4, 1, 2, 3)
    if layer == "complex":
        x = torch.complex(x[:, :CIN].contiguous(), x[:, CIN:].contiguous())
    with torch.no_grad():
        out = module(x)
    out = out.permute(0, 2, 3, 4, 1).numpy()
    want = ref[f"{case}/{dtype}"]
    assert out.shape == want.shape == (1, *SIZE, COUT)
    assert rel_l2(out, want) <= TOL[dtype]
