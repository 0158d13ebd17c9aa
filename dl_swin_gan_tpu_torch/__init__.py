"""dl_swin_gan_tpu_torch — the PyTorch/CUDA port of dl_swin_gan_tpu.

A second package beside the JAX one, with the same module paths so each
counterpart is easy to find. It imports torch and never jax, flax or the JAX
package. Ported so far: reconstruction and training of the example config
(RES denoiser, PGD solver, float32 or a bfloat16 conv trunk) and of
config_swin.yaml (the unrolled Swin), training and validation of
config_dslr.yaml (DSLR low-rank alternating minimisation), the SE, CBAM and
SwinGAN paths, diffusion reconstruction (DiT, Latte and SwinDiff under
DDPM_X or DDPM_E, trained with EMA and served by conditional sampling), CFL
serving, the evaluator, the quality rows and the headline bench, with
hand-written Hopper kernels for the SENSE normal operator, window attention
(forward and backward) and the block-LLR normal operator (primal and
adjoint).

Layout:
    config/     YAML config system (same schema as the JAX package)
    data/       host-side numpy: CFL IO, operator twins, synthetic phantoms
                and the quality set, the training preprocess, the HDF5 and
                in-memory datasets and the loader
    ops/        FFTs, SENSE operators, VDkt masks, image metrics, LLR block
                operators, conjugate gradient
    kernels/    hand-written CUDA kernels (csrc/) and their plain versions
    models/     denoiser backbones (ResNets with real or complex convs, Swin,
                DiT, Latte, SwinDiff)
    diffusion/  the Gaussian diffusion process, respacing, timestep samplers
    solvers/    unrolled solver, diffusion solver, DSLR solver
    train/      metrics and losses, Adam and StepLR, EMA, checkpoints, the
                Trainer, DSLR, GAN and diffusion trainers and their command
                lines
    infer/      inference transforms, the Reconstructor, CFL and H5 serving,
                checkpoint loading, the SSIM/RMSE/PSNR evaluator
    scripts/    command lines: evaluate, reconstruct (CFL), reconstruct_h5,
                quality_row, train_swin_gan, train_dit, train_latte
    utils/      device choice, float32 precision, the headline configs
    convert.py  JAX param tree <-> torch state_dict; seeded torch init
    bench.py    the headline train-step and reconstruction bench
"""

__version__ = "0.1.0"
