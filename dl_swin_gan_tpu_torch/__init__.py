"""dl_swin_gan_tpu_torch — the PyTorch/CUDA port of dl_swin_gan_tpu.

A second package beside the JAX one, with the same module paths so each
counterpart is easy to find. It imports torch and never jax, flax or the JAX
package. Ported so far: the example-config reconstruction path (RES denoiser,
PGD solver, float32), with a hand-written Hopper kernel for the SENSE normal
operator, and the unrolled-Swin reconstruction path (config_swin.yaml), with
a hand-written Hopper kernel for window attention (forward).

Layout:
    config/     YAML config system (same schema as the JAX package)
    data/       host-side numpy: CFL IO, operator twins, synthetic phantoms
    ops/        FFTs, SENSE operators, VDkt masks
    kernels/    hand-written CUDA kernels (csrc/) and their plain versions
    models/     denoiser backbones (real-valued 3D ResNet, Swin)
    solvers/    unrolled PGD solver
    infer/      inference transforms and the Reconstructor
    utils/      device choice, float32 precision, the headline configs
    convert.py  JAX param tree -> torch state_dict; seeded torch init
"""

__version__ = "0.1.0"
