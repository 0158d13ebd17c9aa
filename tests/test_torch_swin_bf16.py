"""The bfloat16 Swin trunk (CONV_BLOCK.DTYPE bfloat16, MODEL_TYPE SWIN) of
the port against the JAX package's, on converted weights, and what the
built trunk holds (float32 parameters, the layers' compute dtypes).

The JAX side runs in a subprocess with XLA_FLAGS=
--xla_allow_excess_precision=false, as tests/test_torch_bf16.py explains
(XLA's CPU backend otherwise keeps float32 between the bf16 ops), once for
each of the JAX package's two window-attention routes:

  "pallas"  `_window_attention_pallas`, the Pallas kernels in interpret
            mode (`_use_pallas` patched in the subprocess only), whose bf16
            contract is the port's: q, k, v (and g) widened to float32,
            float32 products and softmax, the outputs rounded;
  "xla"     the package's default CPU route `_attention_xla`, which
            multiplies q k^T and p v in bf16 and rounds p to bf16 first: a
            different function of the same inputs.

Two levels, with the parameters' LayerNorms, biases and bias tables moved
off their init:

  - One Swin block (16 features, 8 heads, window (7, 8, 8) on a 4x10x10
    grid: padded, and shifted by (0, 4, 4) or not), its output and the
    gradients of its input and every parameter. Against the Pallas route
    the output agrees bit for bit or to 5e-4 (every bf16 rounding at the
    same place) and the gradients to 2e-3 to 6e-3 (sums in other orders,
    a few bf16 roundings the other way): held to the bf16 RES trunk's
    limits, output rel L2 2e-3 and gradients 2e-2 (tests/test_torch_bf16.py).
    The XLA route's bf16 products move the output by about 3e-3 and the
    gradients by up to 8e-3: held to 1e-2 and 2e-2. The biases of the
    layers that compute in bf16 (qkv, proj, fc1, fc2: flax adds them in
    bf16) are held to 6e-2 on both routes: XLA's CPU backend sums their
    gradient over the positions in bf16 (fc2's is 2.7e-2 from the exact
    sum of the bf16 cotangent, the port's 2.0e-3, one rounding); measured
    0.8e-2 to 3.4e-2.
  - The unrolled Swin solver at 2 unrolls (16 features; the 6 blocks of
    depths (6,), three shifted), its output and all its parameter
    gradients as one vector. There the bf16 roundings themselves spread
    the result as far as the limits above: the JAX package's two routes
    differ from each other by 3.2e-3 (output) and 2.2e-2 (gradient; a
    single parameter of a block by up to 0.3, where its gradient is a sum
    that cancels), and the port's bf16 result from its float32 one by
    3.3e-3 and 3.9e-2. The port's bf16 result is as close to either JAX
    route as those are to each other: measured 3.1e-3 and 3.2e-3
    (output), 2.5e-2 and 2.7e-2 (gradient); held to 5e-3 and 4e-2.

The key third of each qkv bias takes no gradient in exact arithmetic (a
constant added to a query's logits leaves its softmax as it is); its
gradient is roundoff on both sides and is not compared.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dl_swin_gan_tpu_torch.models.swin as S
from dl_swin_gan_tpu_torch.config import load_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer import ResampleTransform
from dl_swin_gan_tpu_torch.infer.reconstruct import batched
from dl_swin_gan_tpu_torch.models import build_denoiser
from dl_swin_gan_tpu_torch.solvers import build_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
YAML = "configs/config_swin.yaml"
# 2 unrolls x 1 swinblock x 16 features in bfloat16, no remat
OVERRIDES = ["MODEL.PARAMETERS.NUM_FEATURES", 16,
             "MODEL.PARAMETERS.NUM_UNROLLS", 2,
             "MODEL.PARAMETERS.GRAD_CHECKPOINT", False,
             "MODEL.PARAMETERS.CONV_BLOCK.DTYPE", "bfloat16"]
T, Y, X, C, E = 8, 40, 40, 4, 2
BLOCK_GRID = (1, 4, 10, 10, 16)
SHIFTS = {"unshifted": (0, 0, 0), "shifted": (0, 4, 4)}
BLOCK_OUT_TOL = {"pallas": 2e-3, "xla": 1e-2}
BLOCK_GRAD_TOL = 2e-2
# the biases flax adds in bf16, whose gradient XLA's CPU backend sums in
# bf16
BF16_BIASES = ("qkv.bias", "proj.bias", "fc1.bias", "fc2.bias")
BF16_BIAS_GRAD_TOL = 6e-2
SOLVER_OUT_TOL, SOLVER_GRAD_TOL = 5e-3, 4e-2


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def toy_cfg(load):
    cfg = load(str(REPO / YAML), freeze=False)
    cfg.merge_from_list(list(OVERRIDES))
    return cfg


def inputs():
    """The block's input x and cotangent gx; one batch of the solver's
    inputs (a slice whose windows shrink in time and pad and shift in
    space) and the cotangent g of the loss sum(Re(conj(g) out))."""
    rng = np.random.RandomState(1)
    x, gx = (rng.standard_normal(BLOCK_GRID).astype(np.float32)
             for _ in range(2))
    ex = ResampleTransform(12, toy_cfg(load_cfg))(
        *make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=0)[:2])
    batch = next(batched([ex], 1))
    shape = batch["init_image"].shape
    g = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return dict(x=x, gx=gx, g=g, **{k: batch[k] for k in (
        "kspace", "maps", "mask", "init_image")})


# the JAX side, into one npz: each module's noisy params, and per route its
# output and gradients
_JAX_SIDE = """
import jax, jax.numpy as jnp, numpy as np
from dl_swin_gan_tpu.config import load_cfg
from dl_swin_gan_tpu.models import build_denoiser
from dl_swin_gan_tpu.models.swin import SwinBlock3D
from dl_swin_gan_tpu.solvers import build_solver
import dl_swin_gan_tpu.kernels.window_attn as JWA
d = dict(np.load({inp!r}))
rng = np.random.RandomState(4)
def noisy(path, leaf):   # LayerNorms, biases and bias tables off their init
    leaf = np.asarray(leaf)
    name = path[-1].key
    if name in ("scale", "bias", "relative_position_bias_table"):
        sigma = 0.1 if name == "scale" else 0.3
        leaf = leaf + sigma * rng.standard_normal(leaf.shape).astype(leaf.dtype)
    return leaf
arrays = {{}}
def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)
blocks, params = {{}}, {{}}
for name, shift in {shifts!r}.items():
    blocks[name] = SwinBlock3D(16, 8, (7, 8, 8), shift, dtype=jnp.bfloat16)
    p = jax.jit(blocks[name].init)(jax.random.PRNGKey(0), d["x"])["params"]
    params[name] = jax.tree_util.tree_map_with_path(noisy, p)
cfg = load_cfg({yaml!r}, freeze=False)
cfg.merge_from_list({overrides!r})
model = build_solver(cfg, lambda: build_denoiser(cfg))
args = (d["kspace"], d["maps"], d["mask"])
p = jax.jit(lambda *a: model.init(jax.random.PRNGKey(0), *a,
                                  x0=d["init_image"])["params"])(*args)
params["solver"] = jax.tree_util.tree_map_with_path(noisy, p)
for name, tree in params.items():
    put(name + "/params", tree)
def solver_loss(p):
    out = model.apply({{"params": p}}, *args, x0=d["init_image"])
    return jnp.sum(jnp.real(jnp.conj(d["g"]) * out)), out
for route in ("xla", "pallas"):
    if route == "pallas":
        JWA._use_pallas = lambda: True
        call = JWA.pl.pallas_call
        JWA.pl.pallas_call = lambda *a, **kw: call(*a, interpret=True, **kw)
    for name, block in blocks.items():
        def loss(p, x):
            out = block.apply({{"params": p}}, x)
            return jnp.sum(out.astype(jnp.float32) * d["gx"]), out
        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params[name], d["x"])
        arrays[f"{{route}}/{{name}}/out"] = np.asarray(out)
        arrays[f"{{route}}/{{name}}/dx"] = np.asarray(gx)
        put(f"{{route}}/{{name}}/grads", gp)
    (_, out), grads = jax.jit(jax.value_and_grad(
        solver_loss, has_aux=True))(params["solver"])
    arrays[route + "/solver/out"] = np.asarray(out)
    put(route + "/solver/grads", grads)
np.savez({out!r}, **arrays)
"""


def unflatten(arrays, prefix):
    """The nested tree of the npz keys under `prefix`."""
    tree = {}
    for key, value in arrays.items():
        if key.startswith(prefix + "/"):
            *parents, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


def run_jax_bf16(code, timeout=600):
    """Run a JAX script in a subprocess on the CPU with XLA's excess
    precision off, from the repo root; fails with its stderr."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]


def with_gradient(name, shape):
    """The elements of a parameter that take a gradient in exact arithmetic
    (not the key third of a qkv bias)."""
    keep = np.ones(tuple(shape), bool)
    if name.endswith("attn.qkv.bias"):
        n = shape[0] // 3
        keep[n:2 * n] = False
    return keep


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("swin_bf16")
    data = inputs()
    np.savez(tmp / "in.npz", **data)
    run_jax_bf16(_JAX_SIDE.format(
        yaml=str(REPO / YAML), overrides=OVERRIDES, shifts=SHIFTS,
        inp=str(tmp / "in.npz"), out=str(tmp / "jax.npz")))
    return data, dict(np.load(tmp / "jax.npz"))


def _block_state(tree):
    prefix = "nets.0.trunks.0.layers.0.blocks.0."
    state = flax_to_torch({"SwinNet3D_0": {"SwinTransformer3D_0": {
        "BasicLayer_0": {"SwinBlock3D_0": tree}}}})
    return {k[len(prefix):]: v for k, v in state.items()}


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("shift", list(SHIFTS))
def test_bf16_swin_block_matches_jax(jax_side, shift, route):
    data, arrays = jax_side
    block = S.SwinBlock3D(16, 8, (7, 8, 8), SHIFTS[shift],
                          dtype=torch.bfloat16).eval()
    block.load_state_dict(_block_state(unflatten(arrays, shift + "/params")))
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    out = block(x)
    (out * torch.from_numpy(data["gx"])).sum().backward()
    at = f"{route}/{shift}"
    assert out.dtype == torch.float32
    assert rel_l2(out.detach().numpy(), arrays[at + "/out"]) <= \
        BLOCK_OUT_TOL[route]
    assert rel_l2(x.grad.numpy(), arrays[at + "/dx"]) <= BLOCK_GRAD_TOL
    jgrads = _block_state(unflatten(arrays, at + "/grads"))
    assert jgrads.keys() == dict(block.named_parameters()).keys()
    for n, p in block.named_parameters():
        keep = with_gradient(n, p.shape)
        tol = (BF16_BIAS_GRAD_TOL if n.endswith(BF16_BIASES)
               else BLOCK_GRAD_TOL)
        assert rel_l2(p.grad.numpy()[keep], jgrads[n].numpy()[keep]) <= \
            tol, n


def _flat_grads(grads, names):
    return np.concatenate([np.asarray(grads[n])[with_gradient(
        n, grads[n].shape)] for n in names])


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_bf16_swin_solver_matches_jax(jax_side, route):
    """The solver's output and the gradients of sum(Re(conj(g) out)) with
    respect to every parameter (one vector), against either JAX route."""
    data, arrays = jax_side
    model = build_model(toy_cfg(load_cfg)).eval()
    model.load_state_dict(flax_to_torch(unflatten(arrays, "solver/params")))
    out = model(*(torch.from_numpy(data[k]) for k in
                  ("kspace", "maps", "mask")),
                x0=torch.from_numpy(data["init_image"]))
    torch.sum(torch.real(torch.from_numpy(data["g"]).conj() * out)).backward()
    assert out.dtype == torch.complex64
    assert rel_l2(out.detach().numpy(), arrays[route + "/solver/out"]) <= \
        SOLVER_OUT_TOL
    jgrads = flax_to_torch(unflatten(arrays, route + "/solver/grads"))
    # FIX_STEP_SIZE: the step size takes no gradient
    grads = {n: p.grad for n, p in model.named_parameters()
             if n != "step_size"}
    assert grads.keys() == set(jgrads) - {"step_size"} and len(grads) > 50
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
    names = sorted(grads)
    assert rel_l2(_flat_grads(grads, names), _flat_grads(jgrads, names)) \
        <= SOLVER_GRAD_TOL


def test_bf16_swin_trunk_layer_dtypes():
    """build_denoiser's bfloat16 Swin: float32 parameters; the linears,
    the patch embedding and unembedding and the ConvBlocks compute in
    bfloat16; window attention gets bfloat16 q, k, v with a float32 bias
    (and mask) and returns bfloat16; the trunk's output is complex64."""
    net = build_denoiser(toy_cfg(load_cfg),
                         generator=torch.Generator().manual_seed(0))
    assert isinstance(net, S.SwinNet3D)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    trunk = net.trunks[0]
    block = trunk.layers[0].blocks[1]
    assert trunk.dtype == torch.bfloat16 and net.sfe.conv.dtype == \
        torch.bfloat16 and net.out_conv.conv.dtype == torch.bfloat16
    assert {block.attn.qkv.dtype, block.attn.proj.dtype, block.mlp.fc1.dtype,
            block.mlp.fc2.dtype} == {torch.bfloat16}
    seen = []
    real = S.window_attention

    def record(q, k, v, bias, mask=None):
        out = real(q, k, v, bias, mask)
        seen.append((q.dtype, k.dtype, v.dtype, bias.dtype,
                     None if mask is None else mask.dtype, out.dtype))
        return out

    S.window_attention = record
    try:
        # 10 x 10 patches: the (7, 8, 8) window shifts by (0, 4, 4)
        x = torch.randn(1, 2, 6, 40, 40, dtype=torch.complex64,
                        generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            out = net.eval()(x)
    finally:
        S.window_attention = real
    assert out.dtype == torch.complex64 and torch.isfinite(
        torch.view_as_real(out)).all()
    bf, f32 = torch.bfloat16, torch.float32
    assert seen[:2] == [(bf, bf, bf, f32, None, bf), (bf, bf, bf, f32, f32, bf)]
