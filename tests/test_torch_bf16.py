"""The bfloat16 conv trunk (CONV_BLOCK.DTYPE) of the port against the JAX
package's, on converted weights: the RES denoiser's forward and parameter
gradients with real and complex convs, its float32 path, the parameter and
gradient dtypes, a 3-step trajectory against the JAX Trainer, and the
bfloat16 Swin trunk's build (its parity: tests/test_torch_swin_bf16.py).

The JAX side of the forward and gradient test runs in a subprocess with
XLA_FLAGS=--xla_allow_excess_precision=false. XLA's CPU backend otherwise
drops the f32 -> bf16 -> f32 round trips around each conv (its default
allows excess precision), so its "bf16" trunk would be nearly the float32
one: its gradients 4 % to 8 % from the port's, which rounds as `conv_nd`
says (and as the TPU's bf16 products do).

Tolerances (rel L2). float32: 1e-4, as tests/test_torch_model.py (sums in
other orders). bfloat16: both sides round each conv's input, kernel and
output to bfloat16 and accumulate in float32 in other orders, so an output
near a rounding boundary (or a ReLU input near 0) goes the other way on
one side: the outputs agree to 2e-3 (measured 6e-5 real, 4e-4 complex, where
float32 is 1e-3 away) and the gradients to 2e-2 (measured at most 1.1e-2 on
the real trunk, 1.6e-3 complex; each is 3e-3 to 1e-1 from float32).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.trainer import Trainer as JaxTrainer
from dl_swin_gan_tpu_torch.config import get_cfg, load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.models import build_denoiser
from dl_swin_gan_tpu_torch.train import Trainer
from dl_swin_gan_tpu_torch.utils.headline import swin_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
OUT_TOL = {"float32": 1e-4, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CASES = [(dtype, complex_layers) for dtype in ("bfloat16", "float32")
         for complex_layers in (False, True)]
SHAPE = (2, 2, 6, 14, 12)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfg(cfg, dtype, complex_layers):
    cfg.MODEL.MODEL_TYPE = "RES"
    p = cfg.MODEL.PARAMETERS
    p.NUM_RESBLOCKS = 2
    p.NUM_FEATURES = 16
    p.NUM_EMAPS = 2
    p.CONV_BLOCK.COMPLEX = complex_layers
    p.CONV_BLOCK.DTYPE = dtype
    return cfg


def _inputs():
    """x and the cotangent g of the loss sum(Re(conj(g) out))."""
    rng = np.random.RandomState(0)

    def c64():
        return (rng.standard_normal(SHAPE)
                + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)

    return c64(), c64()


# the JAX side: params, output and gradients of each case, flattened to
# "case/kind/path/to/leaf" -> array in one npz
_JAX_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_bf16 import CASES, _cfg, _inputs
from dl_swin_gan_tpu.config import get_cfg
from dl_swin_gan_tpu.models import build_denoiser
x, g = _inputs()
arrays = {{}}
def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(p.key for p in path)
        arrays[prefix + "/" + key] = np.asarray(leaf)
for i, (dtype, complex_layers) in enumerate(CASES):
    net = build_denoiser(_cfg(get_cfg(), dtype, complex_layers))
    params = jax.jit(net.init)(jax.random.PRNGKey(0), x)["params"]
    def loss(p):
        out = net.apply({{"params": p}}, x)
        return jnp.sum(jnp.real(jnp.conj(g) * out)), out
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    put(f"{{i}}/params", params)
    put(f"{{i}}/grads", grads)
    arrays[f"{{i}}/out"] = np.asarray(out)
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
    return {"ResNet3D_0": tree}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bf16") / "jax.npz")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = _JAX_SIDE.format(tests=str(REPO / "tests"), path=path)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("case", range(len(CASES)), ids=[
    f"{dtype}-{'complex' if c else 'real'}" for dtype, c in CASES])
def test_res_trunk_matches_jax(jax_side, case):
    """The denoiser's output and the gradients of sum(Re(conj(g) out)) with
    respect to every parameter, on converted weights."""
    dtype, complex_layers = CASES[case]
    x, g = _inputs()
    net = build_denoiser(_cfg(get_cfg(), dtype, complex_layers))
    state = flax_to_torch(_unflatten(jax_side, f"{case}/params"))
    net.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    out = net(torch.from_numpy(x))
    torch.sum(torch.real(torch.from_numpy(g).conj() * out)).backward()

    assert out.dtype == torch.complex64
    assert _rel_l2(out.detach().numpy(), jax_side[f"{case}/out"]) <= \
        OUT_TOL[dtype]
    jgrads = flax_to_torch(_unflatten(jax_side, f"{case}/grads"))
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert len(grads) == len(jgrads) >= 8
    for n, grad in grads.items():
        assert grad.dtype == torch.float32 and torch.isfinite(grad).all(), n
        assert _rel_l2(grad.numpy(), jgrads["nets.0." + n].numpy()) <= \
            GRAD_TOL[dtype], n


def test_bf16_trunk_keeps_float32_params_and_activations():
    """Parameters stay float32; each conv computes in bfloat16 (its output
    differs from the float32 conv's), but returns float32."""
    net = build_denoiser(_cfg(get_cfg(), "bfloat16", False),
                         generator=torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    conv = net.head.conv
    assert conv.dtype == torch.bfloat16
    x = torch.randn(1, 4, 6, 14, 12, generator=torch.Generator().manual_seed(1))
    y = conv(x)
    assert y.dtype == torch.float32
    f32 = torch.nn.functional.conv3d(x, conv.weight, conv.bias, padding=1)
    assert not torch.equal(y, f32)
    assert _rel_l2(y.detach().numpy(), f32.detach().numpy()) <= 1e-2
    ref = torch.nn.functional.conv3d(
        x.bfloat16(), conv.weight.bfloat16(), padding=1).float() + \
        conv.bias.reshape(-1, 1, 1, 1)
    assert torch.equal(y, ref)


def test_swin_bf16_builds_with_float32_params():
    """config_swin.yaml's trunk with CONV_BLOCK.DTYPE bfloat16 builds (it
    raised before the bf16 window-attention kernels were ported): float32
    parameters, every ConvBlock, linear and patch conv in bfloat16 (the
    trunk's parity with the JAX package: tests/test_torch_swin_bf16.py)."""
    cfg = swin_cfg()
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "bfloat16"
    net = build_denoiser(cfg)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    typed = [type(m).__name__ for m in net.modules() if hasattr(m, "dtype")
             and m.dtype == torch.bfloat16]
    # the 4 ConvBlocks' convs, the trunk (its patch convs), 6 blocks x 4
    # linears; nothing left in float32
    assert sorted(typed) == ["Conv"] * 4 + ["Linear"] * 24 + [
        "SwinTransformer3D"]
    assert all(m.dtype == torch.bfloat16 for m in net.modules()
               if hasattr(m, "dtype"))


def test_unknown_dtype_raises():
    cfg = _cfg(get_cfg(), "float16", False)
    with pytest.raises(ValueError, match="DTYPE"):
        build_denoiser(cfg)


def test_bf16_trajectory_matches_jax_trainer():
    """configs/quality/resnet_bf16.yaml at toy widths (DEVICE_PIPELINE off,
    the host preprocess on both sides): converted weights, the same three
    batches, 3 Adam steps; each step's loss within 1e-2 relative of the JAX
    Trainer's (bfloat16 on both sides, see the module note)."""
    yaml = "configs/quality/resnet_bf16.yaml"
    overrides = ["MODEL.PARAMETERS.NUM_FEATURES", 8,
                 "MODEL.PARAMETERS.NUM_UNROLLS", 2,
                 "DATALOADER.DEVICE_PIPELINE", False,
                 "AUG_TRAIN.CROP_READOUT", 24, "OPTIMIZER.ADAM.LR", 0.001]
    cfg = load_cfg(str(REPO / yaml), freeze=False)
    cfg.merge_from_list(overrides)
    jcfg = jax_load_cfg(str(REPO / yaml), freeze=False)
    jcfg.merge_from_list(overrides)
    assert cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE == "bfloat16"
    pre = CinePreprocess(cfg, use_seed=True)
    batches = []
    for i in range(3):
        ex = pre(*make_cine_example(T=8, Y=48, X=32, C=4, E=2, seed=i),
                 f"traj_{i}")
        batches.append({k: np.asarray(v)[None] for k, v in ex.items()})

    jtrainer = JaxTrainer(jcfg)
    jtrainer.set_steps_per_epoch(len(batches))
    jstate = jtrainer.init_state(batches[0])
    jtrainer._build_steps()
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    trainer = Trainer(cfg, device="cpu")
    trainer.set_steps_per_epoch(len(batches))
    state = trainer.init_state(state_dict=flax_to_torch(params))

    ours, theirs = [], []
    for b in batches:
        ours.append(float(trainer.train_step(state, b)["Train/complex_l1"]))
        jstate, metrics = jtrainer._train_step(jstate, packing.pack(b))
        theirs.append(float(metrics["Train/complex_l1"]))
    np.testing.assert_allclose(ours, theirs, rtol=1e-2)
    assert len(set(ours)) == 3
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
