"""The bfloat16 DiT and Latte trunks (CONV_BLOCK.DTYPE bfloat16; the JAX
package's configs/quality/dit_bf16.yaml cut to 2 layers x 32 hidden, 8
heads) of the port against the JAX package's, on the CPU: each backbone's
output and the gradients of every parameter on (x, t, y), and a 3-step
DiffusionTrainer trajectory of the DiT solver with the JAX trainer's t and
noise fed to the port.

The weights are numpy draws shaped by `jax.eval_shape` of the flax init
(tests/test_torch_gates.seeded_params: no zero adaLN or final layer), made
here; the JAX side runs in a subprocess with XLA_FLAGS=
--xla_allow_excess_precision=false (tests/test_torch_bf16.py says why).
Both sides round at the same places (flax's `Dense(dtype=)` and
`Conv(dtype=)`, the attention's bf16 products and its probabilities
rounded before p v, jax.nn.gelu op by op): the attention, the patch
embedding and the final layer agree bit for bit and a DiT block to 3e-6
(measured module by module). Through the whole backbone a rounding that
goes the other way (a sum in another order; a bf16 logit of magnitude 10
has an ulp of 0.06) spreads: the port's bf16 DiT is 5.4e-3 from its own
float32 DiT, and 3.0e-3 from the JAX bf16 DiT (Latte 1.0e-3). Limits,
with what was measured:

  - output rel L2 4e-3 (3.0e-3 DiT, 1.0e-3 Latte);
  - the gradients as one vector 2e-2 (1.5e-2, 3.8e-3), each parameter
    6e-2 (up to 3.3e-2 and 3.7e-2; XLA's CPU backend also sums the
    gradient of a bias that flax adds in bf16 over every token in bf16);
  - each trajectory step's loss rel 1e-2, as the bf16 RES trajectory
    (tests/test_torch_bf16.py; measured 6e-5 to 1.2e-4).
"""

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.models import build_denoiser
from dl_swin_gan_tpu_torch.train import DiffusionTrainer
from tests.test_torch_diffusion import jax_solver_and_params, operands
from tests.test_torch_diffusion_train import _batches, _train_cfg
from tests.test_torch_gates import seeded_params
from tests.test_torch_swin_bf16 import (
    REPO, rel_l2, run_jax_bf16, unflatten, with_gradient,
)

torch.set_num_threads(1)

ROOTS = {"DIT": "DiTResNet_0", "LATTE": "LatteNet_0"}
OUT_TOL, GRAD_TOL, PARAM_GRAD_TOL, LOSS_RTOL = 4e-3, 2e-2, 6e-2, 1e-2
DECAY = 0.5


def toy_cfg(get, model_type):
    """dit_bf16.yaml's trunk at 2 layers x 32 hidden, 8 heads (Latte at the
    same widths), on the toy diffusion config of the trajectory tests."""
    cfg = _train_cfg(get, model_type, "DDPM_X")
    p = cfg.MODEL.PARAMETERS
    p.NUM_LAYERS, p.NUM_FEATURES, p.NUM_HEADS = 2, 32, 8
    p.PATCH_SIZE = (2, 4, 4)
    p.CONV_BLOCK.DTYPE = "bfloat16"
    return cfg


def _flat(tree, prefix, arrays):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _flat(leaf, f"{prefix}/{key}", arrays)
        else:
            arrays[f"{prefix}/{key}"] = np.asarray(leaf)
    return arrays


_JAX_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from dl_swin_gan_tpu.config import get_cfg
from dl_swin_gan_tpu.models import build_denoiser
from dl_swin_gan_tpu.train import packing
from dl_swin_gan_tpu.train.diffusion_trainer import DiffusionTrainer
from dl_swin_gan_tpu.train.train_state import TrainState
from test_torch_swin_bf16 import unflatten
from test_torch_dit_bf16 import toy_cfg
d = dict(np.load({inp!r}))
arrays = {{}}
def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)
for model_type in ("DIT", "LATTE"):
    net = build_denoiser(toy_cfg(get_cfg, model_type), deterministic=True)
    def loss(p):
        out = net.apply({{"params": p}}, d["x"], d["t"], d["y"])
        return jnp.sum(jnp.real(jnp.conj(d["g"]) * out)), out
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        unflatten(d, model_type + "/params"))
    arrays[model_type + "/out"] = np.asarray(out)
    put(model_type + "/grads", grads)
cfg = toy_cfg(get_cfg, "DIT")
trainer = DiffusionTrainer(cfg, ema_decay={decay!r}, sample_steps=3)
params = unflatten(d, "solver/params")
state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=trainer.tx.init(params), ema_params=params)
trainer._build_steps()
for step in range(3):
    b = {{k[len(f"batch{{step}}/"):]: v for k, v in d.items()
         if k.startswith(f"batch{{step}}/")}}
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.SEED + 7), step)
    k_t, k_noise, _ = jax.random.split(key, 3)
    n = b["target"].shape[0]
    arrays[f"t{{step}}"] = np.asarray(jax.random.randint(k_t, (n,), 0, 1000))
    arrays[f"noise{{step}}"] = np.asarray(jax.random.normal(
        k_noise, (n, 2 * b["target"].shape[1]) + b["target"].shape[2:],
        jnp.float32))
    state, metrics = trainer._train_step(
        state, packing.pack(trainer.prepare_batch(b)))
    arrays[f"loss{{step}}"] = np.asarray(metrics["Train MSE"])
np.savez({out!r}, **arrays)
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The inputs, the seeded float32 weights and the JAX side's results."""
    tmp = tmp_path_factory.mktemp("dit_bf16")
    x, maps, mask, t = operands(5)
    rng = np.random.RandomState(6)
    data = dict(x=x, t=t, y=np.ones((x.shape[0],), np.int32),
                g=(rng.standard_normal(x.shape)
                   + 1j * rng.standard_normal(x.shape)).astype(np.complex64))
    arrays = dict(data)
    for i, model_type in enumerate(ROOTS):
        net = jax_build_denoiser(toy_cfg(jax_get_cfg, model_type))
        _flat(seeded_params(net, x, t, data["y"], seed=1 + i),
              model_type + "/params", arrays)
    batches = _batches(toy_cfg(get_cfg, "DIT"))
    first = batches[0]
    _, solver_params = jax_solver_and_params(
        toy_cfg(jax_get_cfg, "DIT"), first["target"], first["maps"],
        first["mask"], seed=3)
    _flat(solver_params, "solver/params", arrays)
    for step, b in enumerate(batches):
        arrays.update({f"batch{step}/{k}": v for k, v in b.items()})
    np.savez(tmp / "in.npz", **arrays)
    run_jax_bf16(_JAX_SIDE.format(tests=str(REPO / "tests"),
                                  inp=str(tmp / "in.npz"),
                                  out=str(tmp / "jax.npz"), decay=DECAY))
    return arrays, batches, dict(np.load(tmp / "jax.npz"))


@pytest.mark.parametrize("model_type", list(ROOTS))
def test_bf16_backbone_matches_jax(jax_side, model_type):
    arrays, _, jax_out = jax_side
    net = build_denoiser(toy_cfg(get_cfg, model_type)).eval()
    state = flax_to_torch({ROOTS[model_type]: unflatten(
        arrays, model_type + "/params")})
    net.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    out = net(torch.from_numpy(arrays["x"]), torch.from_numpy(
        arrays["t"]).long(), torch.from_numpy(arrays["y"]).long())
    torch.sum(torch.real(torch.from_numpy(arrays["g"]).conj() * out)
              ).backward()
    assert out.dtype == torch.complex64
    assert rel_l2(out.detach().numpy(), jax_out[model_type + "/out"]) <= \
        OUT_TOL
    jgrads = flax_to_torch({ROOTS[model_type]: unflatten(
        jax_out, model_type + "/grads")})
    grads = {k.split(".", 2)[2]: v for k, v in jgrads.items()}
    flat_ours, flat_theirs = [], []
    for n, p in net.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        keep = with_gradient(n, p.shape)
        ours, theirs = p.grad.numpy()[keep], grads[n].numpy()[keep]
        flat_ours.append(ours)
        flat_theirs.append(theirs)
        assert rel_l2(ours, theirs) <= PARAM_GRAD_TOL, n
    assert rel_l2(np.concatenate(flat_ours), np.concatenate(flat_theirs)) \
        <= GRAD_TOL


def test_bf16_dit_trajectory_matches_jax_diffusion_trainer(jax_side):
    """3 DiffusionTrainer steps of the bf16 DiT solver (DDPM_X) from the
    same weights on the same batches, the JAX trainer's t and noise fed to
    the port: each step's loss."""
    arrays, batches, jax_out = jax_side
    trainer = DiffusionTrainer(toy_cfg(get_cfg, "DIT"), device="cpu",
                               ema_decay=DECAY, sample_steps=3)
    state = trainer.init_state(state_dict=flax_to_torch(unflatten(
        arrays, "solver/params")))
    ours = []
    for step, b in enumerate(batches):
        t = torch.from_numpy(jax_out[f"t{step}"])
        noise = torch.from_numpy(jax_out[f"noise{step}"])
        ours.append(float(trainer.train_step(state, b, t=t,
                                             noise=noise)["Train MSE"]))
    theirs = [float(jax_out[f"loss{step}"]) for step in range(3)]
    np.testing.assert_allclose(ours, theirs, rtol=LOSS_RTOL)
    assert len(set(ours)) == 3 and state.step == 3
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
