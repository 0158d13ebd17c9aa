"""DSLR: unrolled alternating minimisation over locally-low-rank factors
(L, R).

Counterpart of `solvers/dslr.py` in the JAX package (the reference's
`dl_cs/models/dslr.py`). Modes:

  dslr-pgd        gradient steps on L and R, step sizes -0.9 / the largest
                  singular value of the other factor (10 power-method
                  steps from JAX's uniform(PRNGKey(0)) start vector, drawn
                  by `ops/threefry.py`), then the CNN updates
  dslr-cg-v1      CG on each factor's normal equations, L and R data
                  consistency both before the CNN updates
  dslr-cg-v2      interleaved: L-DC, L-CNN, R-DC, R-CNN (the real CGv2; the
                  reference's dispatcher routes this name to CGv1)
  dslr-cg-jacobi  both factor solves against the previous unroll's (L, R),
                  in one paired CG whose operator runs both systems in one
                  kernel launch (no reference counterpart)
  modslr-v1       MoDL penalties lambda_l / lambda_r: the DC solves
                  (A^H A + lam) factor = rhs with the CNN output as prior
  modslr-v2       carries (L, zL, R, zR), lambdas 1e2 * clamp(lam, 0), and
                  composes the image from (zL, zR)

Shapes: L [N, e*b^2, r], R [N, t, r]. The spatial CNN is a 2D ResNet on
[N, r*e, b, b] (channels (r, e), r-major), the temporal CNN a 1D ResNet on
[N, r, t], or with `use_rnn_temporal` a bidirectional LSTM over t on
[N, t, r] (`models/rnn.py`, hidden width NUM_FEATURES). No config sets
`use_rnn_temporal`: as in the JAX package, `build_dslr_solver` leaves it
off and only a directly built `UnrolledLR` reaches it. Every application
of block_op(A.normal(compose(.))) goes through the block-LLR normal kernel
(`kernels/llr_normal.py`): on a CUDA device there is no other route.
"""

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dl_swin_gan_tpu_torch.kernels.llr_normal import make_fused_block_normal
from dl_swin_gan_tpu_torch.models.resnet import ResNet1D, ResNet2D
from dl_swin_gan_tpu_torch.models.rnn import RNN
from dl_swin_gan_tpu_torch.ops import threefry
from dl_swin_gan_tpu_torch.ops.cg import (
    conjugate_gradient, paired_conjugate_gradient, power_method,
)
from dl_swin_gan_tpu_torch.ops.llr import BlockOp, btranspose, compose
from dl_swin_gan_tpu_torch.ops.sense import SenseOp


@functools.lru_cache(maxsize=8)
def _pm_start(n: int, r: int) -> np.ndarray:
    """The power method's start vectors [n, r, 1]: float32
    `jax.random.uniform(jax.random.PRNGKey(0), (n, r, 1))`, the JAX
    package's fixed key."""
    return threefry.uniform(0, (n, r, 1))


DSLR_MODES = ("dslr-pgd", "dslr-cg-v1", "dslr-cg-v2", "dslr-cg-jacobi",
              "modslr-v1", "modslr-v2")


class UnrolledLR(nn.Module):
    """solver(y, maps, mask, L0, R0, block_op) -> image [1, E, T, Y, X]
      y     [1, C, T, Y, X] complex   masked k-space
      maps  [1, E, C, 1, Y, X] complex
      mask  [1, 1, T, Y, X] float or None
      L0    [N, e*b^2, r], R0 [N, t, r] complex   the loader's factors
      block_op  a BlockOp over [1, E, T, Y, X]
    """

    def __init__(self, mode: str = "dslr-cg-v1", num_unrolls: int = 5,
                 num_resblocks: int = 2, num_features: int = 64,
                 kernel_size: int = 3, num_emaps: int = 1, num_basis: int = 8,
                 block_size: int = 16, use_complex_layers: bool = True,
                 circular_pad: bool = True, share_weights: bool = False,
                 fix_step_size: bool = False, num_cg_steps: int = 10,
                 remat: bool = False, use_rnn_temporal: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in DSLR_MODES:
            raise ValueError(f"Unknown DSLR mode: {mode}")
        self.mode = mode
        self.num_unrolls = num_unrolls
        self.num_emaps = num_emaps
        self.block_size = block_size
        self.share_weights = share_weights
        self.fix_step_size = fix_step_size
        self.num_cg_steps = num_cg_steps
        self.remat = remat
        n_nets = 1 if share_weights else num_unrolls
        common = dict(num_resblocks=num_resblocks, num_features=num_features,
                      kernel_size=kernel_size,
                      use_complex_layers=use_complex_layers,
                      generator=generator)
        self.spatial = nn.ModuleList(
            ResNet2D(num_emaps=num_basis * num_emaps, circular_pad=False,
                     **common) for _ in range(n_nets))
        if use_rnn_temporal:
            self.temporal = nn.ModuleList(
                RNN(num_basis, hidden_size=num_features, generator=generator)
                for _ in range(n_nets))
        else:
            self.temporal = nn.ModuleList(
                ResNet1D(num_emaps=num_basis, circular_pad=circular_pad,
                         **common) for _ in range(n_nets))
        self.use_rnn_temporal = use_rnn_temporal
        if mode.startswith("modslr"):
            # v1 uses the lambdas as they are, from (1.0, 2.0); v2 starts both
            # at 5e-3 and applies 1e2 * clamp(lambda, 0), a learning-rate trick
            init_l, init_r = (1.0, 2.0) if mode == "modslr-v1" else (5e-3, 5e-3)
            self.lambda_l = nn.Parameter(torch.full((1,), init_l))
            self.lambda_r = nn.Parameter(torch.full((1,), init_r))

    # -- CNN updates ---------------------------------------------------------
    def _run(self, net: nn.Module, h: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(net, h, use_reentrant=False)
        return net(h)

    def _cnn_L(self, i: int, L: torch.Tensor) -> torch.Tensor:
        n, eb2, r = L.shape
        b, e = self.block_size, self.num_emaps
        h = L.transpose(1, 2).reshape(n, r * e, b, b)
        h = self._run(self.spatial[0 if self.share_weights else i], h)
        return h.reshape(n, r, eb2).transpose(1, 2)

    def _cnn_R(self, i: int, R: torch.Tensor) -> torch.Tensor:
        net = self.temporal[0 if self.share_weights else i]
        if self.use_rnn_temporal:
            return self._run(net, R)                        # over t
        return self._run(net, R.transpose(1, 2)).transpose(1, 2)  # [N, r, t]

    @staticmethod
    def _step_sizes(L: torch.Tensor, R: torch.Tensor, alpha: float = 0.9):
        """pgd's steps for L and R: -alpha over the largest singular value
        of R and of L, 10 power-method steps each from one start vector,
        JAX's uniform(PRNGKey(0), (N, r, 1)) (both factors have r
        columns)."""
        v0 = torch.from_numpy(_pm_start(R.shape[0], R.shape[2])).to(
            device=R.device, dtype=R.dtype)
        eL = power_method(R, 10, v0)
        eR = power_method(L, 10, v0)
        return -alpha / eL.max(), -alpha / eR.max()

    # -- the alternating minimisation ----------------------------------------
    def forward(self, y, maps, mask, L0, R0, block_op: BlockOp):
        A = SenseOp(maps, mask)
        fused = make_fused_block_normal(block_op, maps, mask)
        ATy_b = block_op(A(y, adjoint=True))                 # [N, e*b^2, t]
        cg_steps = self.num_cg_steps

        def normal_L(L, R_fixed):
            return fused(L @ btranspose(R_fixed)) @ R_fixed

        def normal_R(R, L_fixed):
            return btranspose(fused(L_fixed @ btranspose(R))) @ L_fixed

        L, R = L0, R0
        if self.mode == "dslr-pgd":
            for i in range(self.num_unrolls):
                # extract is linear: block_op(N(compose) - ATy) is
                # fused(L R^H) - block_op(ATy)
                grad_x = fused(L @ btranspose(R)) - ATy_b
                grad_L = grad_x @ R
                grad_R = btranspose(grad_x) @ L
                sL, sR = self._step_sizes(L, R)
                L = L + sL * grad_L
                R = R + sR * grad_R
                L = self._cnn_L(i, L)
                R = self._cnn_R(i, R)
            return compose(L, R, block_op)

        if self.mode in ("dslr-cg-v1", "dslr-cg-v2"):
            for i in range(self.num_unrolls):
                L = conjugate_gradient(lambda v: normal_L(v, R), L,
                                       ATy_b @ R, cg_steps)
                if self.mode == "dslr-cg-v2":
                    L = self._cnn_L(i, L)
                R = conjugate_gradient(lambda v: normal_R(v, L), R,
                                       btranspose(ATy_b) @ L, cg_steps)
                if self.mode == "dslr-cg-v1":
                    L = self._cnn_L(i, L)
                R = self._cnn_R(i, R)
            return compose(L, R, block_op)

        if self.mode == "dslr-cg-jacobi":
            for i in range(self.num_unrolls):
                Lf, Rf = L, R   # both solves see the previous unroll's iterate

                def normal_pair(vL, vR, Lf=Lf, Rf=Rf):
                    oL, oR = fused(vL @ btranspose(Rf), Lf @ btranspose(vR))
                    return oL @ Rf, btranspose(oR) @ Lf

                L, R = paired_conjugate_gradient(
                    normal_pair, L, R, ATy_b @ Rf, btranspose(ATy_b) @ Lf,
                    cg_steps)
                L = self._cnn_L(i, L)
                R = self._cnn_R(i, R)
            return compose(L, R, block_op)

        lam_l, lam_r = self.lambda_l, self.lambda_r
        if self.fix_step_size:
            lam_l, lam_r = lam_l.detach(), lam_r.detach()
        if self.mode == "modslr-v1":
            ll, lr = lam_l[0], lam_r[0]
        else:
            ll = 1e2 * torch.clamp(lam_l[0], min=0.0)
            lr = 1e2 * torch.clamp(lam_r[0], min=0.0)

        def dc_L(L, zL, R_fixed):
            return conjugate_gradient(
                lambda v: ll * v + normal_L(v, R_fixed), L,
                ll * zL + ATy_b @ R_fixed, cg_steps)

        def dc_R(R, zR, L_fixed):
            return conjugate_gradient(
                lambda v: lr * v + normal_R(v, L_fixed), R,
                lr * zR + btranspose(ATy_b) @ L_fixed, cg_steps)

        if self.mode == "modslr-v1":
            for i in range(self.num_unrolls):
                zL = self._cnn_L(i, L)
                L = dc_L(L, zL, R)
                zR = self._cnn_R(i, R)
                R = dc_R(R, zR, L)
            return compose(L, R, block_op)

        # modslr-v2: the first unroll fixes R0, later ones the previous zR
        zL, zR = torch.zeros_like(L0), torch.zeros_like(R0)
        for i in range(self.num_unrolls):
            L = dc_L(L, zL, R if i == 0 else zR)
            zL = self._cnn_L(i, L)
            R = dc_R(R, zR, zL)
            zR = self._cnn_R(i, R)
        return compose(zL, zR, block_op)


def build_dslr_solver(cfg, generator: Optional[torch.Generator] = None,
                      use_rnn_temporal: bool = False) -> UnrolledLR:
    """The DSLR solver META_ARCHITECTURE names; `generator` seeds its
    weights (torch-default init). No config key sets `use_rnn_temporal`,
    as in the JAX package; only a caller that asks for it gets the RNN
    temporal nets."""
    p = cfg.MODEL.PARAMETERS
    meta = cfg.MODEL.META_ARCHITECTURE.lower()
    if meta not in DSLR_MODES:
        raise ValueError(f"Unknown DSLR META_ARCHITECTURE: {meta}")
    return UnrolledLR(
        mode=meta,
        num_unrolls=p.NUM_UNROLLS,
        num_resblocks=p.NUM_RESBLOCKS,
        num_features=p.NUM_FEATURES,
        kernel_size=p.CONV_BLOCK.KERNEL_SIZE[0],
        num_emaps=p.NUM_EMAPS,
        num_basis=p.DSLR.NUM_BASIS,
        block_size=p.DSLR.BLOCK_SIZE,
        use_complex_layers=p.CONV_BLOCK.COMPLEX,
        circular_pad=p.CONV_BLOCK.CIRCULAR_PAD,
        share_weights=p.SHARE_WEIGHTS,
        fix_step_size=p.FIX_STEP_SIZE,
        num_cg_steps=p.DSLR.NUM_CG_STEPS,
        remat=p.GRAD_CHECKPOINT,
        use_rnn_temporal=use_rnn_temporal,
        generator=generator,
    )
