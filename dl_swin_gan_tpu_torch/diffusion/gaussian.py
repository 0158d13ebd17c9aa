"""Gaussian diffusion: schedules, q and p, DDIM, conditional hard-DC
sampling and the training losses.

Counterpart of `diffusion/gaussian.py` in the JAX package (OpenAI ADM/IDDPM
adapted to complex images), with its quirks kept:

  - the "linear" schedule ends at beta = scale * 0.0008, not 0.02;
  - training noise lives in the stacked real/imag representation
    (`tensor2realimag`) while the model takes complex tensors;
  - sampling runs on complex tensors with complex normal noise, re and im
    each N(0, 1/2) (torch's complex `randn`);
  - `p_sample_loop_conditional` applies hard data consistency
    x <- A_F^H (A_1 x + A x0) after every step except t = 0;
  - `training_kspace_loss` is an L1 between the full-k-space projections of
    the model output and of the fully-sampled target.

The schedules stay numpy float64, as in the JAX package; a step takes them
as float32 tensors. Every random draw comes from an explicit generator or
is injected: the samplers take a `randn(shape, dtype)` callable
(`generator_randn` makes one of a `torch.Generator`), the losses a `noise`
tensor or a generator, so a test can feed the JAX package's own draws.
"""

import enum
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

Randn = Callable[[tuple, torch.dtype], torch.Tensor]


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


# ---------------------------------------------------------------- schedules

def get_beta_schedule(name: str, *, beta_start, beta_end,
                      num_steps) -> np.ndarray:
    if name == "quad":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps,
                           dtype=np.float64) ** 2
    if name == "linear":
        return np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    if name == "const":
        return beta_end * np.ones(num_steps, dtype=np.float64)
    if name == "jsd":
        return 1.0 / np.linspace(num_steps, 1, num_steps, dtype=np.float64)
    raise NotImplementedError(name)


def betas_for_alpha_bar(num_steps: int, alpha_bar, max_beta: float = 0.999):
    betas = []
    for i in range(num_steps):
        t1, t2 = i / num_steps, (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    if name == "linear":
        scale = 1000 / num_steps
        # the reference's beta_end is scale * 0.0008
        return get_beta_schedule("linear", beta_start=scale * 0.0001,
                                 beta_end=scale * 0.0008, num_steps=num_steps)
    if name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_steps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {name}")


# ---------------------------------------------------------------- helpers

def tensor2realimag(x: torch.Tensor) -> torch.Tensor:
    """[N, C, ...] complex -> [N, 2C, ...] float."""
    return torch.cat([x.real, x.imag], dim=1)


def tensor2complex(x: torch.Tensor) -> torch.Tensor:
    """[N, 2C, ...] float -> [N, C, ...] complex."""
    c = x.shape[1] // 2
    return torch.complex(x[:, :c].contiguous(), x[:, c:].contiguous())


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    v = x.abs() if x.is_complex() else x
    return v.reshape(v.shape[0], -1).mean(dim=1)


def generator_randn(generator: torch.Generator) -> Randn:
    """`randn(shape, dtype)` drawing from `generator` on its device:
    standard normal for a real dtype, re and im each N(0, 1/2) for a
    complex one."""
    def randn(shape, dtype):
        return torch.randn(shape, dtype=dtype, generator=generator,
                           device=generator.device)
    return randn


def _need(randn: Optional[Randn]) -> Randn:
    if randn is None:
        raise ValueError("pass the noise, or a randn to draw it from "
                         "(every draw comes from an explicit generator)")
    return randn


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal Gaussians."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a 1/255-discretized Gaussian."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_delta))


# ---------------------------------------------------------------- engine

class GaussianDiffusion:
    """Schedule arrays are numpy float64; methods act on torch tensors
    (real stacked-channel or complex) on any device."""

    def __init__(self, *, betas, model_mean_type: ModelMeanType,
                 model_var_type: ModelVarType, loss_type: LossType):
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type

        betas = np.array(betas, dtype=np.float64)
        assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
        self.betas = betas
        self.num_timesteps = int(betas.shape[0])

        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas, axis=0)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.alphas_cumprod_next = np.append(self.alphas_cumprod[1:], 0.0)

        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.log_one_minus_alphas_cumprod = np.log(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(
            1.0 / self.alphas_cumprod - 1)

        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev)
            / (1.0 - self.alphas_cumprod))
        self.posterior_log_variance_clipped = (
            np.log(np.append(self.posterior_variance[1],
                             self.posterior_variance[1:]))
            if len(self.posterior_variance) > 1 else np.array([]))
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev)
            / (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - self.alphas_cumprod))
        self.one_minus_alphas_cumprod = 1.0 - self.alphas_cumprod
        self.log_betas = np.log(betas)
        large = np.append(self.posterior_variance[1], betas[1:])
        self._fixed = {
            ModelVarType.FIXED_LARGE: (large, np.log(large)),
            ModelVarType.FIXED_SMALL: (self.posterior_variance,
                                       self.posterior_log_variance_clipped),
        }
        self._tables: Dict[tuple, torch.Tensor] = {}

    # -- utilities --------------------------------------------------------
    def _extract(self, arr: np.ndarray, t: torch.Tensor,
                 ndim: int) -> torch.Tensor:
        """arr[t] as float32 on t's device, shaped to broadcast over a
        tensor of `ndim` dims. `arr` is one of the schedule's arrays; its
        float32 copy is cached per device, built outside inference mode so
        a later training step can use it."""
        key = (id(arr), t.device)
        table = self._tables.get(key)
        if table is None:
            with torch.inference_mode(False):
                table = torch.as_tensor(np.asarray(arr, np.float32),
                                        device=t.device)
            self._tables[key] = table
        return table[t.long()].reshape((-1,) + (1,) * (ndim - 1))

    def _wrap_t(self, t: torch.Tensor) -> torch.Tensor:
        """Hook for SpacedDiffusion's timestep remapping."""
        return t

    # -- q ------------------------------------------------------------------
    def q_mean_variance(self, x_start, t):
        nd = x_start.ndim
        mean = self._extract(self.sqrt_alphas_cumprod, t, nd) * x_start
        variance = self._extract(self.one_minus_alphas_cumprod, t, nd)
        log_variance = self._extract(self.log_one_minus_alphas_cumprod, t, nd)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (self._extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + self._extract(self.sqrt_one_minus_alphas_cumprod, t, nd)
                * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (self._extract(self.posterior_mean_coef1, t, nd) * x_start
                + self._extract(self.posterior_mean_coef2, t, nd) * x_t)
        variance = self._extract(self.posterior_variance, t, nd)
        log_variance = self._extract(self.posterior_log_variance_clipped, t,
                                     nd)
        return mean, variance, log_variance

    # -- p ------------------------------------------------------------------
    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - self._extract(self.sqrt_recipm1_alphas_cumprod, t, nd)
                * eps)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return ((self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                 - pred_xstart)
                / self._extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def p_mean_variance(self, model: Callable, x, t,
                        clip_denoised: bool = True, denoised_fn=None,
                        model_kwargs: Optional[dict] = None
                        ) -> Dict[str, torch.Tensor]:
        """`model(x, t, **kwargs)`; x may be complex."""
        model_kwargs = model_kwargs or {}
        nd = x.ndim
        model_output = model(x, self._wrap_t(t), **model_kwargs)

        if self.model_var_type in (ModelVarType.LEARNED,
                                   ModelVarType.LEARNED_RANGE):
            model_output, var_values = torch.chunk(model_output, 2, dim=1)
            if var_values.is_complex():
                var_values = var_values.real
            min_log = self._extract(self.posterior_log_variance_clipped, t,
                                    nd)
            max_log = self._extract(self.log_betas, t, nd)
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            variance, log_variance = self._fixed[self.model_var_type]
            model_variance = self._extract(variance, t, nd)
            model_log_variance = self._extract(log_variance, t, nd)

        def process_xstart(v):
            if denoised_fn is not None:
                v = denoised_fn(v)
            if clip_denoised and not v.is_complex():
                return torch.clamp(v, -1, 1)
            return v

        if self.model_mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
        else:
            pred_xstart = process_xstart(
                self._predict_xstart_from_eps(x_t=x, t=t, eps=model_output))
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance,
                "pred_xstart": pred_xstart}

    def p_sample(self, model, x, t, clip_denoised=True, denoised_fn=None,
                 model_kwargs=None, noise: Optional[torch.Tensor] = None,
                 randn: Optional[Randn] = None):
        """One ancestral sampling step; `noise` (like x) or a `randn` to
        draw it from."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn,
                                   model_kwargs)
        if noise is None:
            noise = _need(randn)(x.shape, x.dtype)
        nonzero = (t != 0).to(torch.float32).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        sample = (out["mean"]
                  + nonzero * torch.exp(0.5 * out["log_variance"]) * noise)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _indices(self):
        return list(range(self.num_timesteps))[::-1]

    def p_sample_loop(self, model, shape=None, noise=None,
                      clip_denoised=True, denoised_fn=None,
                      model_kwargs=None, randn: Optional[Randn] = None):
        """The full reverse chain from `noise` (or a real normal draw of
        `shape`)."""
        randn = _need(randn)
        img = noise if noise is not None else randn(shape, torch.float32)
        for i in self._indices():
            t = torch.full((img.shape[0],), i, dtype=torch.long,
                           device=img.device)
            img = self.p_sample(model, img, t, clip_denoised, denoised_fn,
                                model_kwargs, randn=randn)["sample"]
        return img

    def p_sample_loop_conditional(self, model, noise, model_kwargs,
                                  clip_denoised=False, denoised_fn=None,
                                  randn: Optional[Randn] = None):
        """Reverse chain with hard k-space data consistency after every
        step except t = 0. `noise` is the zero-filled init image (complex);
        model_kwargs must hold the SenseOps A, A_1 and A_F, and the model
        receives all of them, operators included."""
        A_F, A_1, A = model_kwargs["A_F"], model_kwargs["A_1"], \
            model_kwargs["A"]
        randn = _need(randn)
        init_img = noise
        acquired = A(init_img)
        img = init_img
        for i in self._indices():
            t = torch.full((img.shape[0],), i, dtype=torch.long,
                           device=img.device)
            img = self.p_sample(model, img, t, clip_denoised, denoised_fn,
                                model_kwargs, randn=randn)["sample"]
            if i != 0:
                # acquired lines from init_img, the rest from the model
                img = A_F(A_1(img) + acquired, adjoint=True)
        return img

    # -- DDIM -----------------------------------------------------------------
    def ddim_sample(self, model, x, t, clip_denoised=True, denoised_fn=None,
                    model_kwargs=None, eta=0.0,
                    noise: Optional[torch.Tensor] = None,
                    randn: Optional[Randn] = None):
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn,
                                   model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        nd = x.ndim
        alpha_bar = self._extract(self.alphas_cumprod, t, nd)
        alpha_bar_prev = self._extract(self.alphas_cumprod_prev, t, nd)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        if noise is None:
            noise = _need(randn)(x.shape, x.dtype)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        nonzero = (t != 0).to(torch.float32).reshape((-1,) + (1,) * (nd - 1))
        return {"sample": mean_pred + nonzero * sigma * noise,
                "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model, x, t, clip_denoised=True,
                            denoised_fn=None, model_kwargs=None):
        """The deterministic forward ODE step."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn,
                                   model_kwargs)
        nd = x.ndim
        eps = ((self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x
                - out["pred_xstart"])
               / self._extract(self.sqrt_recipm1_alphas_cumprod, t, nd))
        alpha_bar_next = self._extract(self.alphas_cumprod_next, t, nd)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model, shape=None, noise=None,
                         clip_denoised=True, denoised_fn=None,
                         model_kwargs=None, eta=0.0,
                         randn: Optional[Randn] = None):
        randn = _need(randn)
        img = noise if noise is not None else randn(shape, torch.float32)
        for i in self._indices():
            t = torch.full((img.shape[0],), i, dtype=torch.long,
                           device=img.device)
            img = self.ddim_sample(model, img, t, clip_denoised, denoised_fn,
                                   model_kwargs, eta, randn=randn)["sample"]
        return img

    # -- VLB / losses -------------------------------------------------------
    def _vb_terms_bpd(self, model, x_start, x_t, t, clip_denoised=True,
                      model_kwargs=None):
        """The variational bound term of step t, in bits."""
        true_mean, _, true_logvar = self.q_posterior_mean_variance(
            x_start, x_t, t)
        out = self.p_mean_variance(model, x_t, t, clip_denoised,
                                   model_kwargs=model_kwargs)
        kl = normal_kl(true_mean, true_logvar, out["mean"],
                       out["log_variance"])
        kl = mean_flat(kl) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        output = torch.where(t == 0, decoder_nll, kl)
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_kspace_loss(self, model, x_start, t, model_kwargs,
                             noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None):
        """The DDPM_X k-space L1 loss. x_start: complex [N, E, T, Y, X]
        fully-sampled target; `noise` real [N, 2E, T, Y, X] (drawn from
        `generator` when None). Returns (terms, im_output, x_t complex)."""
        x_ri = tensor2realimag(x_start)
        if noise is None:
            noise = _need(generator and generator_randn(generator))(
                x_ri.shape, x_ri.dtype)
        x_t = tensor2complex(self.q_sample(x_ri, t, noise))
        im_output = model(x_t, self._wrap_t(t), **model_kwargs)
        A_F = model_kwargs["A_F"]
        l1 = torch.mean(torch.abs(A_F(im_output) - A_F(model_kwargs["fs"])))
        return {"l1": l1, "MSE": l1, "loss": l1}, im_output, x_t

    def training_losses(self, model, x_start, t, model_kwargs=None,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
        """The eps/x0 MSE (or the VB) with the complex<->real conversions.
        Returns (terms, model_output complex, x_t complex)."""
        model_kwargs = model_kwargs or {}
        x_ri = tensor2realimag(x_start)
        if noise is None:
            noise = _need(generator and generator_randn(generator))(
                x_ri.shape, x_ri.dtype)
        x_t_ri = self.q_sample(x_ri, t, noise)
        x_t_c = tensor2complex(x_t_ri)

        terms = {}
        if self.loss_type.is_vb():
            def wrapped(v, tt, **kw):
                return tensor2realimag(model(tensor2complex(v),
                                             self._wrap_t(tt), **kw))
            terms["loss"] = self._vb_terms_bpd(
                wrapped, x_ri, x_t_ri, t, clip_denoised=False,
                model_kwargs=model_kwargs)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms, None, x_t_c

        model_output = tensor2realimag(
            model(x_t_c, self._wrap_t(t), **model_kwargs))
        if self.model_var_type in (ModelVarType.LEARNED,
                                   ModelVarType.LEARNED_RANGE):
            model_output, var_values = torch.chunk(model_output, 2, dim=1)
            frozen = torch.cat([model_output.detach(), var_values], dim=1)
            terms["vb"] = self._vb_terms_bpd(
                lambda *a, **kw: frozen, x_ri, x_t_ri, t,
                clip_denoised=False)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_ri, x_t_ri, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_ri
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = (terms["mse"] + terms["vb"] if "vb" in terms
                         else terms["mse"])
        return terms, tensor2complex(model_output), x_t_c

    def _prior_bpd(self, x_start):
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1,
                       dtype=torch.long, device=x_start.device)
        qt_mean, _, qt_logvar = self.q_mean_variance(x_start, t)
        zero = torch.zeros((), device=x_start.device)
        return mean_flat(normal_kl(qt_mean, qt_logvar, zero, zero)) \
            / math.log(2.0)

    def calc_bpd_loop(self, model, x_start, clip_denoised=True,
                      model_kwargs=None, randn: Optional[Randn] = None):
        """The full variational bound in bits per dim, over every t from the
        last to 0; one real normal draw per step."""
        randn = _need(randn)
        B = x_start.shape[0]
        vb, xstart_mse, eps_mse = [], [], []
        for i in self._indices():
            t = torch.full((B,), i, dtype=torch.long, device=x_start.device)
            noise = randn(x_start.shape, x_start.dtype)
            x_t = self.q_sample(x_start, t, noise)
            out = self._vb_terms_bpd(model, x_start, x_t, t, clip_denoised,
                                     model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            eps_mse.append(mean_flat((eps - noise) ** 2))
        vb = torch.stack(vb)
        prior_bpd = self._prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=0) + prior_bpd,
                "prior_bpd": prior_bpd, "vb": vb,
                "xstart_mse": torch.stack(xstart_mse),
                "mse": torch.stack(eps_mse)}
