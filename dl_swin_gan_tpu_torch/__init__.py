"""dl_swin_gan_tpu_torch — the PyTorch/CUDA port of dl_swin_gan_tpu.

A second package beside the JAX one, with the same module paths so each
counterpart is easy to find. It imports torch and never jax, flax or the JAX
package. Ported so far: reconstruction and training of the example config
(RES denoiser, PGD solver, float32) and of config_swin.yaml (the unrolled
Swin), and training and validation of config_dslr.yaml (DSLR low-rank
alternating minimisation), with hand-written Hopper kernels for the SENSE
normal operator, window attention (forward and backward) and the block-LLR
normal operator (primal and adjoint).

Layout:
    config/     YAML config system (same schema as the JAX package)
    data/       host-side numpy: CFL IO, operator twins, synthetic phantoms,
                the training preprocess, the HDF5 dataset and loader
    ops/        FFTs, SENSE operators, VDkt masks, image metrics, LLR block
                operators, conjugate gradient
    kernels/    hand-written CUDA kernels (csrc/) and their plain versions
    models/     denoiser backbones (ResNets with real or complex convs, Swin)
    solvers/    unrolled PGD solver, DSLR solver
    train/      metrics and losses, Adam and StepLR, checkpoints, Trainer and
                DSLRTrainer and their command lines
    infer/      inference transforms, the Reconstructor, checkpoint loading
    utils/      device choice, float32 precision, the headline configs
    convert.py  JAX param tree -> torch state_dict; seeded torch init
"""

__version__ = "0.1.0"
