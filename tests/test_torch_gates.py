"""The SE and CBAM gated trunks of the port against the JAX package's, on
weights converted by `flax_to_torch` from a flax init: real and complex
convs, full and separable, the forward and the gradients of every
parameter (float32 on both sides, rel L2 1e-4: sums in other orders); one
bfloat16 CBAM trunk, whose JAX side runs in a subprocess with XLA's excess
precision off as tests/test_torch_bf16.py explains (2e-3 on the output,
2e-2 on the gradients); `normalize` and a normalised ConvBlock; the
CONV_BLOCK.NORM quirk kept from the JAX `build_denoiser`; and the SE and CBAM
configs built in code against their YAMLs."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu.models.layers import ConvBlock as JaxConvBlock
from dl_swin_gan_tpu.models.layers import normalize as jax_normalize
from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.models import build_denoiser
from dl_swin_gan_tpu_torch.models.cbam import CBAMResNet3D
from dl_swin_gan_tpu_torch.models.layers import ConvBlock, normalize
from dl_swin_gan_tpu_torch.models.resnet import ChannelGate, SpatialGate
from dl_swin_gan_tpu_torch.models.se import SEResNet3D
from dl_swin_gan_tpu_torch.utils.headline import quality_cfg, se_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHAPE = (2, 2, 6, 12, 10)
TOL = 1e-4
BF16_OUT_TOL, BF16_GRAD_TOL = 2e-3, 2e-2
# (MODEL_TYPE, complex convs, separable)
CASES = [(m, c, s) for m in ("SE", "CBAM") for c in (False, True)
         for s in (False, True)]
ROOTS = {"SE": "SEResNet3D_0", "CBAM": "CBAMResNet3D_0",
         "RES": "ResNet3D_0"}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfg(cfg, model_type, complex_layers=False, separable=False,
         dtype="float32", norm="none"):
    cfg.MODEL.MODEL_TYPE = model_type
    p = cfg.MODEL.PARAMETERS
    p.NUM_RESBLOCKS = 2
    p.NUM_FEATURES = 8
    p.NUM_EMAPS = 2
    p.RR = 3
    p.CONV_BLOCK.COMPLEX = complex_layers
    p.CONV_BLOCK.SEPARABLE = separable
    p.CONV_BLOCK.DTYPE = dtype
    p.CONV_BLOCK.NORM = norm
    return cfg


def _inputs():
    """x and the cotangent g of the loss sum(Re(conj(g) out))."""
    rng = np.random.RandomState(0)

    def c64():
        return (rng.standard_normal(SHAPE)
                + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)

    return c64(), c64()


def seeded_params(module, *args, seed=0, **kwargs):
    """A flax module's parameter tree drawn with numpy from a seed: each
    kernel N(0, 1/fan_in), each bias N(0, 0.01). (Tracing the init for its
    shapes is far cheaper on the CPU than compiling it.)"""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda *a: module.init(
        jax.random.PRNGKey(0), *a, **kwargs), *args)

    def draw(leaf):
        n = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1e4
        return (rng.standard_normal(leaf.shape) / np.sqrt(n)).astype(
            np.float32)

    return jax.tree_util.tree_map(draw, shapes["params"])


def _jax_side(jcfg, x, g):
    """(params, output, gradients) of the JAX denoiser, as numpy trees."""
    net = jax_build_denoiser(jcfg)
    params = seeded_params(net, x)

    def loss(p):
        out = net.apply({"params": p}, x)
        return jnp.sum(jnp.real(jnp.conj(g) * out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)    # noqa: E731
    return to_np(params), np.asarray(out), to_np(grads)


def _torch_side(cfg, state, x, g):
    """(output, {name: gradient}) of the port's denoiser on `state`."""
    net = build_denoiser(cfg)
    net.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    out = net(torch.from_numpy(x))
    torch.sum(torch.real(torch.from_numpy(g).conj() * out)).backward()
    return out.detach().numpy(), {n: p.grad for n, p in
                                  net.named_parameters()}


def _check(out, grads, ref_out, ref_grads, root, out_tol, grad_tol):
    assert out.shape == ref_out.shape and np.isfinite(out).all()
    assert _rel_l2(out, ref_out) <= out_tol
    jgrads = flax_to_torch({root: ref_grads})
    assert {"nets.0." + n for n in grads} == set(jgrads)
    for n, grad in grads.items():
        assert grad.dtype == torch.float32, n
        assert _rel_l2(grad.numpy(), jgrads["nets.0." + n].numpy()) <= \
            grad_tol, n


@pytest.mark.parametrize("model_type,complex_layers,separable", CASES, ids=[
    f"{m}-{'complex' if c else 'real'}-{'separable' if s else 'full'}"
    for m, c, s in CASES])
def test_gated_trunk_matches_jax(model_type, complex_layers, separable):
    x, g = _inputs()
    params, ref_out, ref_grads = _jax_side(
        _cfg(jax_get_cfg(), model_type, complex_layers, separable), x, g)
    root = ROOTS[model_type]
    state = flax_to_torch({root: params})
    gates = {k for k in state if "gate" in k}
    assert gates and all(".blocks." in k for k in gates)
    assert any("spatial_gate" in k for k in gates) == (model_type == "CBAM")
    assert any(".spatial." in k for k in state) == separable
    out, grads = _torch_side(
        _cfg(get_cfg(), model_type, complex_layers, separable), state, x, g)
    _check(out, grads, ref_out, ref_grads, root, TOL, TOL)


def test_separable_width_truncates_as_jax():
    """sp = int(k^3 cin cout / (k^2 cin + k cout)): 4 -> 8 channels gives
    int(864 / 60) = 14, 8 -> 8 gives int(1728 / 96) = 18."""
    net = build_denoiser(_cfg(get_cfg(), "SE", separable=True))
    assert net.head.conv.spatial.weight.shape == (14, 4, 1, 3, 3)
    assert net.head.conv.temporal.weight.shape == (8, 14, 3, 1, 1)
    assert net.blocks[0].conv0.conv.spatial.weight.shape == (18, 8, 1, 3, 3)


def test_gated_classes_and_gate_widths():
    """RR is the absolute hidden width of the channel gate; the spatial
    gate is one k=5 conv from the channel mean."""
    se = build_denoiser(_cfg(get_cfg(), "SE"))
    cbam = build_denoiser(_cfg(get_cfg(), "CBAM", complex_layers=True))
    assert type(se) is SEResNet3D and type(cbam) is CBAMResNet3D
    gate = se.blocks[0].channel_gate
    assert isinstance(gate, ChannelGate) and se.blocks[0].spatial_gate is None
    assert gate.fc1.weight.shape == (3, 8) and gate.fc2.weight.shape == (8, 3)
    spatial = cbam.blocks[1].spatial_gate
    assert isinstance(spatial, SpatialGate)
    assert spatial.conv.kernel_re.shape == (1, 1, 5, 5, 5)


def test_gates_stay_float32_under_a_bfloat16_trunk():
    net = build_denoiser(_cfg(get_cfg(), "CBAM", dtype="bfloat16"))
    block = net.blocks[0]
    assert block.conv0.conv.dtype == torch.bfloat16
    assert block.spatial_gate.conv.dtype == torch.float32
    h = torch.randn(1, 8, 4, 6, 6, generator=torch.Generator().manual_seed(0))
    assert block.channel_gate(h).dtype == torch.float32


# the JAX side of the bfloat16 case: params, output and gradients in one npz
_JAX_BF16 = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_gates import _cfg, _inputs, _jax_side
from dl_swin_gan_tpu.config import get_cfg
x, g = _inputs()
params, out, grads = _jax_side(_cfg(get_cfg(), "CBAM", dtype="bfloat16"), x, g)
arrays = {{"out": out}}
for prefix, tree in (("params", params), ("grads", grads)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[prefix + "/" + "/".join(p.key for p in path)] = leaf
np.savez({path!r}, **arrays)
"""


def _unflatten(arrays, prefix):
    tree = {}
    for key, value in arrays.items():
        if key.startswith(prefix + "/"):
            *parents, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


def test_cbam_bf16_trunk_matches_jax(tmp_path):
    """The CBAM trunk with a bfloat16 conv trunk (its gates float32)."""
    path = str(tmp_path / "jax.npz")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = _JAX_BF16.format(tests=str(REPO / "tests"), path=path)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    arrays = dict(np.load(path))
    x, g = _inputs()
    state = flax_to_torch({"CBAMResNet3D_0": _unflatten(arrays, "params")})
    out, grads = _torch_side(_cfg(get_cfg(), "CBAM", dtype="bfloat16"),
                             state, x, g)
    _check(out, grads, arrays["out"], _unflatten(arrays, "grads"),
           "CBAMResNet3D_0", BF16_OUT_TOL, BF16_GRAD_TOL)


@pytest.mark.parametrize("norm_type", ["instance", "batch"])
@pytest.mark.parametrize("is_complex", [False, True])
def test_normalize_and_normalised_conv_block_match_jax(norm_type,
                                                       is_complex):
    """`normalize` alone, then a ConvBlock built with `norm_type` (the only
    way to reach it, in both packages) on converted weights."""
    x, _ = _inputs()
    if not is_complex:
        x = x.real.copy()
    jx = jnp.moveaxis(jnp.asarray(x), 1, -1)             # channels-last
    ref = np.moveaxis(np.asarray(jax_normalize(jx, norm_type)), -1, 1)
    ours = normalize(torch.from_numpy(x), norm_type).numpy()
    assert _rel_l2(ours, ref) <= 1e-5

    jblock = JaxConvBlock(5, (3, 3, 3), "relu", norm_type=norm_type,
                          is_complex=is_complex)
    params = seeded_params(jblock, jx, seed=1)
    ref = np.moveaxis(np.asarray(jax.jit(jblock.apply)({"params": params},
                                                       jx)), -1, 1)
    block = ConvBlock(2, 5, 3, "relu", is_complex=is_complex,
                      norm_type=norm_type)
    state = flax_to_torch({"ResNet3D_0": {"ConvBlock_0": params}})
    block.load_state_dict({k.split(".", 3)[3]: v for k, v in state.items()})
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
    assert _rel_l2(out, ref) <= TOL


def test_normalize_rejects_unknown_type():
    with pytest.raises(ValueError, match="normalization"):
        normalize(torch.zeros(1, 2, 3, 3), "group")


@pytest.mark.parametrize("model_type", ["RES", "SE"])
def test_norm_instance_builds_the_none_trunk_as_jax_does(model_type):
    """The JAX build_denoiser never passes CONV_BLOCK.NORM to the trunk, so a
    config with NORM instance trains the same network as one with none: the
    same parameter tree and the same output in both packages."""
    x, g = _inputs()
    params, ref_out, ref_grads = _jax_side(
        _cfg(jax_get_cfg(), model_type, norm="instance"), x, g)
    none_params = seeded_params(
        jax_build_denoiser(_cfg(jax_get_cfg(), model_type)), x)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(none_params)
    state = flax_to_torch({ROOTS[model_type]: params})
    cfg = _cfg(get_cfg(), model_type, norm="instance")
    assert build_denoiser(cfg).state_dict().keys() == build_denoiser(
        _cfg(get_cfg(), model_type)).state_dict().keys()
    out, grads = _torch_side(cfg, state, x, g)
    _check(out, grads, ref_out, ref_grads, ROOTS[model_type], TOL, TOL)
    none_out, _ = _torch_side(_cfg(get_cfg(), model_type), state, x, g)
    assert np.array_equal(out, none_out)


def test_se_cfg_matches_config_se_yaml():
    """Every field."""
    ours, ref = se_cfg(), load_cfg(str(REPO / "configs/config_se.yaml"))
    assert set(ours) == set(ref)
    for node in ref:
        assert ours[node] == ref[node], node


@pytest.mark.parametrize("model,yaml", [("se", "se.yaml"),
                                        ("cbam", "cbam.yaml")])
def test_gated_quality_cfg_matches_yaml(model, yaml):
    """Field for field, but DATALOADER.DEVICE_PIPELINE (not ported)."""
    ours = quality_cfg("float32", model=model)
    ref = load_cfg(str(REPO / "configs/quality" / yaml))
    assert ref.DATALOADER.DEVICE_PIPELINE and not ours.DATALOADER.DEVICE_PIPELINE
    assert set(ours) == set(ref)
    for node in ref:
        if node == "DATALOADER":
            for key in ref.DATALOADER:
                if key != "DEVICE_PIPELINE":
                    assert ours.DATALOADER[key] == ref.DATALOADER[key], key
        else:
            assert ours[node] == ref[node], node


def test_quality_cfg_rejects_unknown_model():
    with pytest.raises(ValueError, match="model"):
        quality_cfg(model="swin")
