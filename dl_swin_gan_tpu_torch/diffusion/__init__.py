"""Gaussian diffusion for complex MRI reconstruction.

Counterpart of `diffusion/` in the JAX package (the OpenAI ADM/IDDPM
lineage adapted to complex images): the process, respacing, timestep
samplers and the `create_diffusion` factory.
"""

from dl_swin_gan_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion, LossType, ModelMeanType, ModelVarType,
    get_named_beta_schedule,
)
from dl_swin_gan_tpu_torch.diffusion.respace import (
    SpacedDiffusion, space_timesteps,
)


def create_diffusion(
    timestep_respacing,
    noise_schedule: str = "linear",
    use_kl: bool = False,
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    rescale_learned_sigmas: bool = True,
    diffusion_steps: int = 1000,
) -> SpacedDiffusion:
    """The process the reference's `create_diffusion` builds."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    if not learn_sigma:
        var_type = (ModelVarType.FIXED_SMALL if sigma_small
                    else ModelVarType.FIXED_LARGE)
    else:
        var_type = ModelVarType.LEARNED_RANGE
    return SpacedDiffusion(
        use_timesteps=space_timesteps(diffusion_steps, timestep_respacing),
        betas=betas,
        model_mean_type=(ModelMeanType.START_X if predict_xstart
                         else ModelMeanType.EPSILON),
        model_var_type=var_type,
        loss_type=loss_type,
    )
