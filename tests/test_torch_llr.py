"""The torch port's LLR block operator, its block-LLR normal operator (the
plain version the CPU runs, and its autograd rule) and CG, against the JAX
package on the same seeded numpy inputs. The JAX Pallas kernel runs in
interpret mode, as tests/test_llr_kernel.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl_swin_gan_tpu.kernels.llr_normal as JLN
from dl_swin_gan_tpu.ops import cg as jcg
from dl_swin_gan_tpu.ops import llr as jllr
from dl_swin_gan_tpu.ops.sense import sense_normal as jax_sense_normal
from dl_swin_gan_tpu_torch.kernels import llr_normal as LN
from dl_swin_gan_tpu_torch.ops import cg, llr
from dl_swin_gan_tpu_torch.ops.sense import sense_normal

torch.set_num_threads(1)

# float32 on both sides, sums in other orders; O(1) values
ATOL = 2e-4


@pytest.fixture
def interpret(monkeypatch):
    """The JAX Pallas kernel in interpret mode; only this test's reference
    is touched."""
    if not JLN._HAS_PALLAS:
        pytest.skip("this JAX has no pallas")
    orig = JLN.pl.pallas_call
    monkeypatch.setattr(JLN.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))


def _c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _problem(E=1, C=2, T=4, Y=18, X=12, b=4, seed=0):
    """The toy geometry of tests/test_llr_kernel.py: blocks of a BlockOp
    over [1, E, T, Y, X], maps [1, E, C, 1, Y, X] and a mask."""
    rng = np.random.RandomState(seed)
    op = llr.BlockOp(b, (1, E, T, Y, X))
    blk = _c64(rng, op.num_blocks, E * b * b, T)
    maps = _c64(rng, 1, E, C, 1, Y, X)
    mask = (rng.rand(1, 1, T, Y, X) < 0.5).astype(np.float32)
    return op, blk, maps, mask


def _w2(mask, op):
    if mask is None:
        return np.ones((op.nt, op.ny, op.nx), np.float32)
    return np.broadcast_to(mask[0, 0] ** 2, (op.nt, op.ny, op.nx)).copy()


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


# ---------------------------------------------------------------- BlockOp

@pytest.mark.parametrize("E,Y,X,b", [(1, 18, 12, 4), (2, 36, 28, 8),
                                     (2, 19, 13, 4)])
def test_blockop_matches_jax(E, Y, X, b):
    rng = np.random.RandomState(1)
    shape = (1, E, 3, Y, X)
    ours, theirs = llr.BlockOp(b, shape), jllr.BlockOp(b, shape)
    for attr in ("pad_x", "pad_y", "num_blocks_x", "num_blocks_y",
                 "num_blocks", "nx_pad", "ny_pad"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    img = _c64(rng, *shape)
    blk = _c64(rng, ours.num_blocks, E * b * b, 3)
    np.testing.assert_allclose(ours.extract(_t(img)).numpy(),
                               np.asarray(theirs.extract(jnp.asarray(img))),
                               atol=1e-6)
    np.testing.assert_allclose(ours.combine(_t(blk)).numpy(),
                               np.asarray(theirs.combine(jnp.asarray(blk))),
                               atol=1e-6)
    np.testing.assert_allclose(ours.weights.numpy(),
                               np.asarray(theirs.weights), atol=1e-6)
    # the numpy BlockOp runs the JAX package's numpy calls: bit for bit
    np.testing.assert_array_equal(
        llr.BlockOp(b, shape, xp=np).extract(img),
        jllr.BlockOp(b, shape, xp=np).extract(img))


def test_blockop_unnormalized_combine_is_the_adjoint_of_extract():
    rng = np.random.RandomState(2)
    op = llr.BlockOp(8, (1, 2, 3, 20, 16))
    x = _t(_c64(rng, 1, 2, 3, 20, 16))
    b = _t(_c64(rng, op.num_blocks, 2 * 64, 3))
    lhs = cg.zdot(op.extract(x), b)
    rhs = cg.zdot(x, op.combine(b) * (op.weights + 1e-8))
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


@pytest.mark.parametrize("E", [1, 2])
def test_decompose_init_bit_exact_with_jax(E):
    rng = np.random.RandomState(3)
    img = _c64(rng, 1, E, 6, 36, 28)
    ours = llr.decompose_init(img, block_size=8, rank=4)
    theirs = jllr.decompose_init(img, block_size=8, rank=4)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.complex64
        np.testing.assert_array_equal(a, b)


def test_decompose_compose_match_jax():
    rng = np.random.RandomState(4)
    op, jop = llr.BlockOp(8, (1, 2, 6, 36, 28)), jllr.BlockOp(
        8, (1, 2, 6, 36, 28))
    blk = _c64(rng, op.num_blocks, 2 * 64, 6)
    L, R = llr.decompose(_t(blk), 6)        # full rank: exact
    np.testing.assert_allclose((L @ llr.btranspose(R)).numpy(), blk,
                               atol=1e-4)
    jL, jR = jllr.decompose(jnp.asarray(blk), 3)
    np.testing.assert_allclose(
        llr.compose(_t(np.asarray(jL)), _t(np.asarray(jR)), op).numpy(),
        np.asarray(jllr.compose(jL, jR, jop)), atol=1e-5)


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("Y,X,b", [(18, 12, 4), (180, 64, 16)])
def test_projection_matrices_bit_exact_with_jax(Y, X, b):
    op, jop = llr.BlockOp(b, (1, 2, 3, Y, X)), jllr.BlockOp(
        b, (1, 2, 3, Y, X))
    for a, c in zip(LN.projection_matrices(op),
                    JLN.projection_matrices(jop)):
        np.testing.assert_array_equal(a, c)


def test_blocks_mats_layout_matches_jax():
    op, blk, _, _ = _problem(E=2)
    jop = jllr.BlockOp(4, (1, 2, 4, 18, 12))
    mats = LN.blocks_to_mats(_t(blk), op)
    np.testing.assert_array_equal(
        mats.numpy(), np.asarray(JLN.blocks_to_mats(jnp.asarray(blk), jop)))
    np.testing.assert_array_equal(LN.mats_to_blocks(mats, op).numpy(), blk)
    # a leading system axis
    two = torch.stack([_t(blk), _t(blk) * 2])
    np.testing.assert_array_equal(LN.blocks_to_mats(two, op)[1].numpy(),
                                  2 * mats.numpy())


# ---------------------------------------------------------------- the plain version

def _mats_args(op, blk, maps, mask, S):
    """(port args, JAX args) of the matrix form: S systems of mats."""
    py, px, dinv = LN.projection_matrices(op)
    b2 = np.roll(blk, 1, axis=0)
    mats = np.stack([np.asarray(JLN.blocks_to_mats(
        jnp.asarray(v), jllr.BlockOp(op.block_size, (1, op.ne, op.nt, op.ny,
                                                     op.nx))))
        for v in (blk, b2)[:S]])
    w2 = _w2(mask, op)
    m = maps[0, :, :, 0]
    port = [_t(a) for a in (mats, m, w2, py, px, dinv)]
    return port, [jnp.asarray(a) for a in (mats, m, w2, py, px, dinv)]


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("d_side", ["pre", "post"])
def test_plain_matches_jax_matrix_form(d_side, S, masked):
    op, blk, maps, mask = _problem(E=2)
    port, jargs = _mats_args(op, blk, maps, mask if masked else None, S)
    ours = LN.llr_normal_plain(*port, d_side=d_side).numpy()
    theirs = np.asarray(JLN.llr_normal_matrix(*jargs, d_side=d_side))
    assert ours.shape == theirs.shape == (S, 4, 2, 36, 28)
    np.testing.assert_allclose(ours, theirs, atol=ATOL)


@pytest.mark.parametrize("d_side,S,E", [("pre", 1, 1), ("pre", 2, 2),
                                        ("post", 1, 2)])
def test_plain_matches_jax_pallas_interpret(interpret, d_side, S, E):
    op, blk, maps, mask = _problem(E=E)
    port, jargs = _mats_args(op, blk, maps, mask, S)
    ours = LN.llr_normal_plain(*port, d_side=d_side).numpy()
    # the primal through the public custom-VJP entry, the adjoint through
    # the kernel's 'post' variant, which the JAX VJP does not launch
    theirs = np.asarray(JLN.llr_normal_fused(*jargs) if d_side == "pre"
                        else JLN._apply_fused(*jargs, d_side))
    np.testing.assert_allclose(ours, theirs, atol=ATOL)


def test_fused_block_normal_matches_the_operator_chain():
    """make_fused_block_normal == block_op(A.normal(block_op(., adjoint)))
    with the port's own BlockOp and SENSE normal op, for one system and
    for the S=2 pair."""
    op, blk, maps, mask = _problem(E=2, C=3)
    f = LN.make_fused_block_normal(op, _t(maps), _t(mask))

    def chain(v):
        return op(sense_normal(op(v, adjoint=True), _t(maps), _t(mask)))

    b1, b2 = _t(blk), _t(np.roll(blk, 2, axis=-1))
    np.testing.assert_allclose(f(b1).numpy(), chain(b1).numpy(), atol=ATOL)
    o1, o2 = f(b1, b2)
    np.testing.assert_allclose(o1.numpy(), chain(b1).numpy(), atol=ATOL)
    np.testing.assert_allclose(o2.numpy(), chain(b2).numpy(), atol=ATOL)


def test_adjointness():
    """<M b1, b2> == <b1, M^H b2> ('pre' against 'post')."""
    op, blk, maps, mask = _problem(E=2)
    m, w2 = _t(maps[0, :, :, 0]), _t(_w2(mask, op))
    b1, b2 = _t(blk)[None], _t(np.roll(blk, 3, axis=0))[None]
    lhs = cg.zdot(LN.llr_normal(b1, m, w2, op, "pre"), b2)
    rhs = cg.zdot(b1, LN.llr_normal(b2, m, w2, op, "post"))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_gradient_matches_jax_grad(interpret):
    """d/dblocks of sum|M(blocks) * c|^2 through the autograd rule ('post'
    on the cotangent) against jax.grad through llr_normal_fused, whose VJP
    runs the matrix form's 'post'."""
    op, blk, maps, mask = _problem(E=2, T=3)
    jop = jllr.BlockOp(4, (1, 2, 3, 18, 12))
    rng = np.random.RandomState(7)
    weight = _c64(rng, *blk.shape)
    m, w2 = maps[0, :, :, 0], _w2(mask, op)
    py, px, dinv = (jnp.asarray(a) for a in JLN.projection_matrices(jop))

    def jax_loss(v):
        mats = JLN.blocks_to_mats(v, jop)[None]
        out = JLN.mats_to_blocks(JLN.llr_normal_fused(
            mats, jnp.asarray(m), jnp.asarray(w2), py, px, dinv)[0], jop)
        return jnp.sum(jnp.abs(out * weight) ** 2)

    # JAX's gradient of a real loss in a complex input is conj(dL/dz*)*2
    # scaled; PyTorch's is dL/dz* * 2: compare conj of JAX's
    ref = np.conj(np.asarray(jax.grad(jax_loss)(jnp.asarray(blk))))
    v = _t(blk).requires_grad_(True)
    out = LN.make_fused_block_normal(op, _t(maps), _t(mask))(v)
    torch.sum(torch.abs(out * _t(weight)) ** 2).backward()
    got = v.grad.numpy()
    assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref)


@pytest.mark.parametrize("change,error", [
    (lambda m, k: (m[:, :, :, :1].repeat(2, axis=3), k), ValueError),  # 2 sets
    (lambda m, k: (m, np.repeat(k, 2, axis=1)), ValueError),   # per-coil mask
    (lambda m, k: (np.concatenate([m, m]), k), ValueError),    # batch 2
], ids=["two-sets", "per-coil-mask", "batch"])
def test_unfusable_inputs_raise(change, error):
    op, _, maps, mask = _problem()
    m, k = change(maps, mask)
    with pytest.raises(error, match="block-LLR"):
        LN.make_fused_block_normal(op, _t(m), _t(k))


def test_wrapper_checks_its_inputs():
    op, blk, maps, mask = _problem(E=2)
    m, w2 = _t(maps[0, :, :, 0]), _t(_w2(mask, op))
    b = _t(blk)[None]
    with pytest.raises(ValueError, match="blocks"):
        LN.llr_normal(b[:, :-1], m, w2, op)
    with pytest.raises(ValueError, match="w2"):
        LN.llr_normal(b, m, w2[:-1], op)
    with pytest.raises(TypeError):
        LN.llr_normal(b.to(torch.complex128), m, w2, op)
    with pytest.raises(ValueError, match="d_side"):
        LN.llr_normal(b, m, w2, op, "both")
    before = dict(LN.llr_normal.launches)
    LN.llr_normal(b, m, w2, op)              # the CPU runs no kernel
    assert LN.llr_normal.launches == before


# ---------------------------------------------------------------- CG

def _spd_problem(seed=5, n=12):
    rng = np.random.RandomState(seed)
    a = _c64(rng, n, n)
    mat = (a.conj().T @ a + n * np.eye(n)).astype(np.complex64)
    return mat, _c64(rng, n, 3), _c64(rng, n, 3)


def test_conjugate_gradient_matches_jax():
    mat, x0, y = _spd_problem()
    tm = _t(mat)
    ours = cg.conjugate_gradient(lambda v: tm @ v, _t(x0), _t(y), 5).numpy()
    jm = jnp.asarray(mat)
    theirs = np.asarray(jcg.conjugate_gradient(
        lambda v: jm @ v, jnp.asarray(x0), jnp.asarray(y), 5))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    # and it converges to the solve
    full = cg.conjugate_gradient(lambda v: tm @ v, _t(x0), _t(y), 12).numpy()
    np.testing.assert_allclose(full, np.linalg.solve(mat, y), atol=1e-4)


def test_paired_conjugate_gradient_matches_jax():
    ma, xa, ya = _spd_problem(6)
    mb, xb, yb = _spd_problem(7)
    ta, tb = _t(ma), _t(mb)
    ours = cg.paired_conjugate_gradient(
        lambda u, v: (ta @ u, tb @ v), _t(xa), _t(xb), _t(ya), _t(yb), 4)
    ja, jb = jnp.asarray(ma), jnp.asarray(mb)
    theirs = jcg.paired_conjugate_gradient(
        lambda u, v: (ja @ u, jb @ v), *(jnp.asarray(a)
                                        for a in (xa, xb, ya, yb)), 4)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # the pair advances each solve exactly as a single CG does
    single = cg.conjugate_gradient(lambda v: ta @ v, _t(xa), _t(ya), 4)
    np.testing.assert_allclose(ours[0].numpy(), single.numpy(), atol=1e-6)


def test_cg_gradient_matches_jax():
    """Autograd through the unrolled iterations, against jax.grad."""
    mat, x0, y = _spd_problem(8)

    def jloss(yy):
        jm = jnp.asarray(mat)
        return jnp.sum(jnp.abs(jcg.conjugate_gradient(
            lambda v: jm @ v, jnp.asarray(x0), yy, 4)) ** 2)

    ref = np.conj(np.asarray(jax.grad(jloss)(jnp.asarray(y))))
    ty = _t(y).requires_grad_(True)
    tm = _t(mat)
    torch.sum(torch.abs(cg.conjugate_gradient(
        lambda v: tm @ v, _t(x0), ty, 4)) ** 2).backward()
    got = ty.grad.numpy()
    assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref)


def test_jax_sense_chain_agrees_with_the_plain_version():
    """The JAX solver's XLA chain (what UnrolledLR runs on the JAX side)
    against the port's plain version on the same blocks."""
    op, blk, maps, mask = _problem(E=2)
    jop = jllr.BlockOp(4, (1, 2, 4, 18, 12))
    ref = jop(jax_sense_normal(jop(jnp.asarray(blk), adjoint=True),
                               jnp.asarray(maps), jnp.asarray(mask)))
    got = LN.make_fused_block_normal(op, _t(maps), _t(mask))(_t(blk))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
