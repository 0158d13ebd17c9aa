"""The torch port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and nvcc; skipped without them. The card's machine has
no JAX, so run these without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import init_params
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer import Reconstructor, ResampleTransform
from dl_swin_gan_tpu_torch.infer.reconstruct import batched
from dl_swin_gan_tpu_torch.kernels import sense_normal as SN
from dl_swin_gan_tpu_torch.ops import sense

pytestmark = pytest.mark.cuda

# fp32 FMA in another order than cuBLAS; TF32 anywhere would show as ~1e-3
REL_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _c64(rng, dev, *shape):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.complex64)).to(dev)


def _inputs(dev, B, E, C, T, Y, X, seed=0, rows=False):
    """Random images and maps; weights sampled elementwise, or (rows=True)
    on whole k-space rows as a Cartesian mask samples them, with partial
    rows and, where there are several frames, the last one left empty."""
    rng = np.random.RandomState(seed)
    x = _c64(rng, dev, B, E, T, Y, X)
    maps = _c64(rng, dev, B, E, C, Y, X)
    if rows:
        w = (rng.rand(B, T, Y, 1) < 0.1) & (rng.rand(B, T, Y, X) < 0.75)
        if B * T > 1:
            w[-1, -1] = False
    else:
        w = rng.rand(B, T, Y, X) < 0.4
    return x, maps, torch.from_numpy(w.astype(np.float32)).to(dev)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("rows", [False, True], ids=["elements", "rows"])
@pytest.mark.parametrize("shape", [
    (1, 2, 8, 20, 180, 64),     # the headline slice
    (3, 1, 1, 2, 12, 10),
    (2, 2, 3, 3, 33, 7),        # ragged against warps and rows
    (1, 3, 2, 2, 7, 100),       # wider than tall
    (1, 2, 4, 1, 119, 120),     # near the largest frame the kernel takes
])
def test_kernel_matches_plain(dev, shape, rows):
    x, maps, w = _inputs(dev, *shape, rows=rows)
    before = SN.sense_normal.launches
    out = SN.sense_normal(x, maps, w)
    torch.cuda.synchronize()
    assert SN.sense_normal.launches == before + 1
    assert _rel(out, SN.sense_normal_plain(x, maps, w)) <= REL_TOL


def test_kernel_rejects_what_it_cannot_take(dev):
    x, maps, w = _inputs(dev, 1, 2, 2, 2, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        SN.sense_normal(x.transpose(3, 4), maps.transpose(3, 4),
                        w.transpose(2, 3))
    with pytest.raises(TypeError):
        SN.sense_normal(x, maps, w.double())
    big = _inputs(dev, 1, 1, 1, 1, 256, 64)
    with pytest.raises(ValueError, match="shared memory"):
        SN.sense_normal(*big)


def test_normal_gradient_on_card_matches_cpu(dev):
    x, maps, w = _inputs(dev, 1, 2, 3, 2, 16, 12, seed=1)
    maps6, mask = maps.unsqueeze(3), w.unsqueeze(1)
    grads = []
    for d in (dev, torch.device("cpu")):
        v = x.detach().to(d, copy=True).requires_grad_(True)
        (sense.sense_normal(v, maps6.to(d), mask.to(d)).abs() ** 2).sum().backward()
        grads.append(v.grad.cpu())
    assert _rel(grads[0], grads[1]) <= REL_TOL


def test_reconstructor_on_card_matches_cpu(dev):
    cfg = get_cfg()
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS, p.NUM_RESBLOCKS, p.NUM_FEATURES = 2, 1, 8
    p.FIX_STEP_SIZE, p.SLWIN_INIT, p.CONV_BLOCK.COMPLEX = True, True, False
    examples = [ResampleTransform(12, cfg)(
        *make_cine_example(T=8, Y=48, X=16, C=4, E=2, seed=s)[:2])
        for s in (0, 1)]
    batch = next(batched(examples, 2))
    params = init_params(cfg, 0)
    before = SN.sense_normal.launches
    gpu = Reconstructor(cfg, params)(batch)
    assert SN.sense_normal.launches == before + 2
    cpu = Reconstructor(cfg, params, device="cpu")(batch)
    assert np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu) <= REL_TOL
