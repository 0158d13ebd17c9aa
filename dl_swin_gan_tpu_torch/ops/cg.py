"""Conjugate gradient with a fixed iteration count.

Counterpart of `ops/cg.py` in the JAX package (the reference's
`dl_cs/mri/algorithms.py` ConjugateGradient): no early exit, no
preconditioner, complex dot products, and autograd through every
iteration, as the reference backpropagates through its unrolled CG. The
scalars alpha and beta stay 0-d tensors on the device: nothing in the loop
waits for the host.

`power_method` gives `dslr-pgd` its step sizes. Its start vector is the
caller's: the solver passes JAX's `uniform(PRNGKey(0), (b, n, 1))`, drawn
bit for bit by `ops/threefry.py`.

The inner products sum over the whole batch, as the JAX package's do. When
the batch is split over data-parallel ranks, XLA makes that sum global;
here `conjugate_gradient(group=)` all-reduces each inner product over the
ranks that hold the batch's slices, so the step sizes are the
single-device ones.
"""

from typing import Callable, Optional

import torch


def zdot(x1: torch.Tensor, x2: torch.Tensor, group=None) -> torch.Tensor:
    """Complex inner product <x1, x2> = sum(conj(x1) * x2), a 0-d tensor;
    summed over the ranks of `group` too when one is given (the complex
    value all-reduced as two reals, with autograd through the sum)."""
    out = torch.sum(x1.conj() * x2)
    if group is None:
        return out
    from dl_swin_gan_tpu_torch.parallel.mesh import all_reduce_sum

    return all_reduce_sum(out, group)


def zdot_single(x: torch.Tensor, group=None) -> torch.Tensor:
    """The real <x, x>."""
    return zdot(x, x, group).real


def conjugate_gradient(A: Callable, x0: torch.Tensor, y: torch.Tensor,
                       num_iter: int, group: Optional[object] = None
                       ) -> torch.Tensor:
    """Solve A x = y for a Hermitian positive (normal-equation) operator A
    with `num_iter` iterations from x0; the inner products summed over the
    ranks of `group` when one is given."""
    r = y - A(x0)
    x, p, rsold = x0, r, zdot_single(r, group)
    for _ in range(num_iter):
        Ap = A(p)
        alpha = rsold / zdot(p, Ap, group)
        x = x + alpha * p
        r = r - alpha * Ap
        rsnew = zdot_single(r, group)
        p = (rsnew / rsold) * p + r
        rsold = rsnew
    return x


def paired_conjugate_gradient(A2: Callable, x0a: torch.Tensor,
                              x0b: torch.Tensor, ya: torch.Tensor,
                              yb: torch.Tensor, num_iter: int):
    """Two independent CG solves advanced in lockstep, with one call of the
    batched operator A2(pa, pb) -> (A_a pa, A_b pb) per iteration (the
    `dslr-cg-jacobi` mode runs both factor systems in one kernel launch).
    Each solve keeps its own alpha, beta and residual."""
    Ax0a, Ax0b = A2(x0a, x0b)
    ra, rb = ya - Ax0a, yb - Ax0b
    xa, pa, rsa = x0a, ra, zdot_single(ra)
    xb, pb, rsb = x0b, rb, zdot_single(rb)
    for _ in range(num_iter):
        Apa, Apb = A2(pa, pb)
        alpha_a = rsa / zdot(pa, Apa)
        alpha_b = rsb / zdot(pb, Apb)
        xa = xa + alpha_a * pa
        xb = xb + alpha_b * pb
        ra = ra - alpha_a * Apa
        rb = rb - alpha_b * Apb
        rsa_new = zdot_single(ra)
        rsb_new = zdot_single(rb)
        pa = (rsa_new / rsa) * pa + ra
        pb = (rsb_new / rsb) * pb + rb
        rsa, rsb = rsa_new, rsb_new
    return xa, xb


def power_method(A: torch.Tensor, num_iter: int, v0: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Largest singular value of each matrix in a batch A [B, m, n], from
    the start vectors v0 [B, n, 1]: `num_iter` steps of v <- A^H A v,
    ev = ||v|| per matrix, v <- v / (ev + eps). Returns ev [B] (zeros when
    num_iter is 0). Differentiable, as the JAX package's fori_loop is under
    jax.grad."""
    AhA = torch.einsum("bmn,bmk->bnk", A.conj(), A)
    v, ev = v0, torch.zeros(A.shape[0], 1, 1, device=A.device)
    for _ in range(num_iter):
        v = torch.einsum("bnk,bkl->bnl", AhA, v)
        ev = torch.sqrt(torch.sum(v.abs() ** 2, dim=1, keepdim=True))
        v = v / (ev + eps)
    return ev.reshape(A.shape[0])
