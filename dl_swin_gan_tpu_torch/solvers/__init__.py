"""Unrolled meta-architectures composed with a denoiser backbone."""

from dl_swin_gan_tpu_torch.solvers.unrolled import UnrolledSolver, build_solver
