"""The SE quality row's serving through both packages (ROADMAP Queue 3, the
SE row's probe 3): `convert.torch_to_flax` against `flax_to_torch` on the
RES, SE and CBAM solvers (a round trip, bit for bit), and a full-size
quality-set exam served at 12x through the port's and the JAX package's
Reconstructor on the same seeded weights at the SE row's widths (5 unrolls
of 1 gated resblock of 96 features, circular time padding), rel L2 1e-4.

Run as a script it serves exam 000 with trained weights (a state_dict the
port's trainer saved, such as the quality row's) through both packages on
the CPU and prints each slice's rel L2 and both packages' SSIM and PSNR:

    python -m tests.test_torch_se_serving WEIGHTS.pt [--slices N]
"""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.config import load_cfg as jax_load_cfg
from dl_swin_gan_tpu.infer.reconstruct import Reconstructor as JaxReconstructor
from dl_swin_gan_tpu.models import build_denoiser as jax_build_denoiser
from dl_swin_gan_tpu.solvers import build_solver as jax_build_solver
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import (
    flax_to_torch, init_params, torch_to_flax,
)
from dl_swin_gan_tpu_torch.data.synthetic import quality_split
from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_volumes
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    Reconstructor, accel_transform, batched,
)
from dl_swin_gan_tpu_torch.utils.headline import quality_cfg
from tests.test_torch_gates import seeded_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
# (MODEL_TYPE, complex convs, separable)
TRUNKS = [("RES", False, False), ("RES", True, True), ("SE", False, False),
          ("SE", True, False), ("CBAM", False, True), ("CBAM", True, True)]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tiny(cfg, model_type, complex_layers, separable, meta):
    cfg.MODEL.MODEL_TYPE = model_type
    cfg.MODEL.META_ARCHITECTURE = meta
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = 2
    p.NUM_RESBLOCKS = 2
    p.NUM_FEATURES = 8
    p.NUM_EMAPS = 2
    p.RR = 3
    p.CONV_BLOCK.COMPLEX = complex_layers
    p.CONV_BLOCK.SEPARABLE = separable
    return cfg


@pytest.mark.parametrize("model_type,complex_layers,separable", TRUNKS, ids=[
    f"{m}-{'complex' if c else 'real'}-{'separable' if s else 'full'}"
    for m, c, s in TRUNKS])
def test_torch_to_flax_inverts_flax_to_torch(model_type, complex_layers,
                                            separable):
    """A flax solver tree (pgd or hqs, so step_size or lamda) converted to
    the port and back is the same tree, leaf for leaf and bit for bit."""
    meta = "modl" if complex_layers else "dlespirit"
    cfg = _tiny(jax_get_cfg(), model_type, complex_layers, separable, meta)
    rng = np.random.RandomState(0)
    shape = (1, 2, 4, 8, 6)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64)
    maps = np.ones((1, 2, 2, 1, 8, 6), np.complex64)
    mask = np.ones((1, 1, 4, 8, 6), np.float32)
    solver = jax_build_solver(cfg, lambda: jax_build_denoiser(cfg))
    params = jax.tree_util.tree_map(np.asarray, seeded_params(
        solver, jnp.zeros(shape, jnp.complex64), jnp.asarray(maps),
        jnp.asarray(mask), x0=jnp.asarray(x)))
    state = flax_to_torch(params)
    back = torch_to_flax(state, model_type)
    flat = jax.tree_util.tree_flatten_with_path
    ref, got = flat(params)[0], flat(back)[0]
    assert [k for k, _ in ref] == [k for k, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert a.shape == b.shape and np.array_equal(a, b), path
    # the port's own state_dict of that config converts too
    ours = init_params(_tiny(get_cfg(), model_type, complex_layers,
                             separable, meta), 0)
    assert set(flax_to_torch(torch_to_flax(ours, model_type))) == set(ours)


def test_torch_to_flax_rejects_unknown_keys():
    state = init_params(_tiny(get_cfg(), "SE", False, False, "dlespirit"), 0)
    with pytest.raises(KeyError, match="mystery"):
        torch_to_flax({**state, "mystery": torch.zeros(1)}, "SE")


def serve_both(state, slices=None):
    """Exam 000 of the quality set at 12x through the port's and the JAX
    package's Reconstructor (the SE row's config, configs/quality/se.yaml)
    on the CPU, with `state` (the port's state_dict): (port images, JAX
    images, 1x reference), each [slices, E, T, Y, X]."""
    cfg = quality_cfg("float32", "se")
    cfg.freeze()
    jcfg = jax_load_cfg(str(REPO / "configs/quality/se.yaml"))
    _, kspace, maps, _ = quality_split("test", 1)[0]
    n = len(kspace) if slices is None else slices
    resample, full = accel_transform(cfg, 12), accel_transform(cfg, 1)
    examples = [resample(kspace[s], maps[s]) for s in range(n)]
    ours = Reconstructor(cfg, state, device="cpu")
    theirs = JaxReconstructor(jcfg, torch_to_flax(state, "SE"))
    port, jax_out = [], []
    for batch in batched(examples, 1):
        port.append(ours(batch))
        jax_out.append(theirs(batch))
    ref = []
    for s in range(n):
        ex = full(kspace[s], maps[s])
        ref.append(ex["init_image"] * ex["scale"])
    return (np.concatenate(port), np.concatenate(jax_out),
            np.stack(ref).astype(np.complex64))


def test_se_exam_served_through_both_packages():
    """Slice 0 of exam 000 (18x156x96, 8 coils, 2 maps) at 12x, seeded
    torch-default weights at the SE row's widths: the two packages'
    outputs within rel L2 1e-4."""
    port, theirs, _ = serve_both(init_params(quality_cfg("float32", "se"),
                                             0), slices=1)
    assert port.shape == theirs.shape == (1, 2, 18, 156, 96)
    assert np.isfinite(port).all() and _rel_l2(port, theirs) <= TOL


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("weights", help="torch.save'd {'model': state_dict} "
                                        "or a state_dict")
    parser.add_argument("--slices", type=int, default=None)
    args = parser.parse_args(argv)
    payload = torch.load(args.weights, map_location="cpu", weights_only=True)
    state = payload.get("model", payload)
    port, theirs, ref = serve_both(state, args.slices)
    for s in range(len(port)):
        print(f"slice {s}: port vs JAX rel L2 "
              f"{_rel_l2(port[s], theirs[s]):.3e}")
    for tag, images in (("port", port), ("jax", theirs)):
        m = evaluate_volumes(ref, images)
        print(f"{tag}: " + ", ".join(f"{k} {float(np.mean(v)):.5f}"
                                     for k, v in m.items()))
    print(f"exam 000: port vs JAX rel L2 {_rel_l2(port, theirs):.3e}")


if __name__ == "__main__":
    main()
