"""The diffusion trainer for DiT, Latte and SwinDiff reconstruction.

Counterpart of `train/diffusion_trainer.py` in the JAX package (the
reference's train_DiT.py / train_Latte.py, one trainer with the backbone
from MODEL.MODEL_TYPE): two processes, a 1000-step one for training and a
fresh `sample_steps` one for sampling; t drawn uniformly; for DDPM_X the
90/10 split of the acquired lines (`submask_np`) and the k-space L1 loss,
for DDPM_E the eps MSE; Adam (`train_state.make_optimizer` and the
Trainer's clip, accumulation and StepLR); the EMA of the weights
(`ema_decay` 0.9999) after every step; conditional hard-DC sampling.

One module serves as the JAX package's two (the deterministic and the
stochastic model share their weights there): `train()` for the train step,
`eval()` for validation and sampling. The step's t and noise come from a
generator on the trainer's device re-seeded from (SEED + 7, step), so the
card's step draws them without the host; `train_step` also takes them as
arguments, so a test can feed the JAX package's draws, or the same draws
to a CPU and a GPU step. The RENORMALIZE_DATA scaling multiplies
the target (and so the loss) by the batch's scale, as in the JAX package.

`validate` scores the training objective on the validation batches: the
same deliberate divergence from the reference as the JAX package's (the
reference scores training_kspace_loss on the initial guess, a leftover of
before its training step moved to the target). With
EVAL.RECON_SSIM_EVERY_N_EPOCHS it also samples the first validation batch
from the raw and the EMA weights and scores the SSIM against the target.
Every LOGGER.LOG_PREDICTION_EVERY_N_STEPS steps fit samples the step's
batch from the EMA weights, its noise from a generator of its own seeded by
the step, and logs the magnitude strip as "Train/sampled_magnitude" (the
JAX trainer's); fit prepares each batch before its step, so the sampled
batch carries the step's own DDPM_X split.

Under a mesh t and the noise are drawn for the global batch from the
step's generator and each rank takes its slice, so the ranks draw
different t and together the one-rank step's; a global host batch gets
its 90/10 submasks drawn before it is split. A draw-seeded host loader
draws each example's split in its transform, keyed by the example's global
position, so a rank's slice carries the one-rank split; an unseeded one's
rank slice draws it from a stream of its own, seeded by the rank.
"""

import copy
import logging
from typing import Dict, Optional

import numpy as np
import torch

from dl_swin_gan_tpu_torch.data.host_ops import submask_np
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.diffusion import create_diffusion
from dl_swin_gan_tpu_torch.diffusion.gaussian import Randn, generator_randn
from dl_swin_gan_tpu_torch.parallel.mesh import (
    RankBatch, batch_shard, global_mean, shard_batch,
    shard_batch_or_replicate, unpermute_qkv,
)
from dl_swin_gan_tpu_torch.solvers.diffusion_unrolled import (
    build_diffusion_solver, model_kwargs,
)
from dl_swin_gan_tpu_torch.train.trainer import (
    MetricsWriter, Trainer, dropout_seed, magnitude_strip,
)
from dl_swin_gan_tpu_torch.train.train_state import (
    TrainState, ema_update, full_ema, is_sharded,
)

logger = logging.getLogger(__name__)


class DiffusionTrainer(Trainer):
    """DDPM_X / DDPM_E trainer with EMA, on `cuda` unless the caller asks
    for the CPU."""

    batch_keys = ("maps", "mask", "mask_r", "mask_p", "init_image", "scale",
                  "target")

    def __init__(self, cfg, device=None, ema_decay: float = 0.9999,
                 sample_steps: int = 100, draw_seed: Optional[int] = None,
                 mesh=None):
        super().__init__(cfg, device=device, use_ema=True,
                         ema_decay=ema_decay, draw_seed=draw_seed, mesh=mesh)
        p = cfg.MODEL.PARAMETERS
        self.meta = cfg.MODEL.META_ARCHITECTURE.lower()
        predict_xstart = self.meta != "ddpm_e"
        self.diffusion = create_diffusion(
            timestep_respacing="", noise_schedule=p.NOISE_SCHED,
            diffusion_steps=1000, learn_sigma=p.LEARN_SIGMA,
            predict_xstart=predict_xstart)
        # a fresh shorter process for sampling, as the reference's
        self.diffusion2 = create_diffusion(
            timestep_respacing="", noise_schedule=p.NOISE_SCHED,
            diffusion_steps=sample_steps, learn_sigma=p.LEARN_SIGMA,
            predict_xstart=predict_xstart)
        self.submask_rng = np.random.RandomState(cfg.SEED + 99)
        # an unseeded host loader's rank slice (a RankBatch): a stream of
        # the rank's (a draw-seeded loader draws the split per example)
        self.rank_submask_rng = np.random.RandomState(
            [cfg.SEED + 99, batch_shard(self.mesh)[0]])
        self.draw_generator = torch.Generator(device=self.device)
        self._ema_model = None

    # -- hooks of Trainer -------------------------------------------------
    def build_model(self, generator: torch.Generator) -> torch.nn.Module:
        return build_diffusion_solver(self.cfg, generator=generator)

    def _device_pipeline_kwargs(self) -> dict:
        return {"diffusion": True}

    def make_preprocess(self, aug_node=None, use_seed=False, draw_seed=None):
        return CinePreprocess(self.cfg, aug_node=aug_node, use_seed=use_seed,
                              draw_seed=draw_seed,
                              submask=self.meta == "ddpm_x")

    @property
    def train_metric(self) -> str:
        return "Train MSE"

    @property
    def default_monitor(self) -> str:
        return "Validate MSE"

    # -- batches ----------------------------------------------------------
    def prepare_batch(self, batch: dict) -> dict:
        """A host batch (numpy) for the diffusion paths: no raw k-space; for
        DDPM_X the 90/10 split of the acquired lines from the trainer's
        RandomState(SEED + 99), else mask_r = mask_p = mask. A split the
        loader drew (the device pipeline's, a draw-seeded host loader's,
        keyed by each example's global position) is kept."""
        kind = type(batch)      # a RankBatch stays one
        rng = (self.rank_submask_rng if isinstance(batch, RankBatch)
               else self.submask_rng)
        batch = kind({k: v for k, v in batch.items() if k != "kspace"})
        if "mask_r" in batch:
            return batch
        if self.meta == "ddpm_x":
            batch["mask_r"], batch["mask_p"] = submask_np(
                np.asarray(batch["mask"], np.float32), 0.9, rng)
        else:
            batch["mask_r"] = batch["mask_p"] = batch["mask"]
        return batch

    def _fit_batch(self, batch):
        """fit prepares the batch before its step (train_step keeps a
        prepared batch's split), so that the logged sample sees the batch
        the step trained on."""
        return self.prepare_batch(batch)

    def _log_images(self, writer: Optional[MetricsWriter], state: TrainState,
                    batch) -> None:
        """Every LOGGER.LOG_PREDICTION_EVERY_N_STEPS steps: conditional
        hard-DC sampling of the step's prepared batch from the EMA weights
        (the JAX trainer's; reference train_DiT.py:283-291), the noise from
        a generator seeded by the step; rank 0 writes the magnitude strip.
        Every rank samples (a sharded model's EMA copy gathers)."""
        every = self.cfg.LOGGER.LOG_PREDICTION_EVERY_N_STEPS
        if not every or state.step % every:
            return
        gen = self.sample(self.ema_model(state), batch, seed=state.step)
        if writer is not None:
            writer.image(state.step, "Train/sampled_magnitude",
                         magnitude_strip(gen))

    def _target(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        target = b["target"]
        if self.renormalize:
            target = target * b["scale"].reshape(
                (-1,) + (1,) * (target.ndim - 1))
        return target

    def draws(self, seed_base: int, index: int, target: torch.Tensor,
              sharded: bool = False):
        """(t, noise) of one loss evaluation: t uniform over the training
        process, the noise standard normal over the stacked real/imag
        target, on the trainer's device from its generator seeded from
        (seed_base, index). With `sharded` the target is this rank's slice:
        the draws are the global batch's, and this rank's slice of them is
        returned."""
        g = self.draw_generator.manual_seed(dropout_seed(seed_base, index))
        rank, count = batch_shard(self.mesh) if sharded else (0, 1)
        B = target.shape[0] * count
        t = torch.randint(0, self.diffusion.num_timesteps, (B,), generator=g,
                          device=self.device)
        shape = (B, 2 * target.shape[1]) + tuple(target.shape[2:])
        noise = torch.randn(shape, generator=g, device=self.device)
        if count == 1:
            return t, noise
        return shard_batch({"t": t, "noise": noise}, self.mesh).values()

    def _loss(self, model, b, t, noise):
        target = self._target(b)
        kwargs = model_kwargs(b["maps"], b["mask_p"], target, b["mask_r"])
        if self.meta == "ddpm_x":
            terms, _, _ = self.diffusion.training_kspace_loss(
                model, target, t, kwargs, noise=noise)
        else:
            terms, _, _ = self.diffusion.training_losses(
                model, target, t, kwargs, noise=noise)
        return torch.mean(terms["loss"])

    # -- steps ------------------------------------------------------------
    def train_step(self, state: TrainState, batch: dict,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One batch: the loss at (t, noise) (drawn from (SEED + 7, step)
        when not given), backward, the optimizer update every
        GRAD_ACCUM_ITERS batches, and the EMA. Updates `state` in place.
        Under a mesh given t and noise are the global batch's (sliced here
        with it) or already this rank's slice."""
        model = state.model.train()
        self._set_batch_group(model, True)
        b = self._to_device(shard_batch(self.prepare_batch(batch), self.mesh))
        self.dropout_generator.manual_seed(
            dropout_seed(self.cfg.SEED + 17, state.step))
        if t is None or noise is None:
            t, noise = self.draws(self.cfg.SEED + 7, state.step, b["target"],
                                  sharded=True)
        elif t.shape[0] != b["target"].shape[0]:
            t, noise = shard_batch({"t": t, "noise": noise},
                                   self.mesh).values()
        if state.step % self.accum == 0:
            state.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(model, b, t.to(self.device), noise.to(self.device))
        loss.backward()
        self._update(model.parameters(), state.optimizer, self.lr_schedule,
                     state.step)
        ema_update(state.ema, model, self.ema_decay)
        state.step += 1
        self._ema_model = None
        return global_mean({"Train MSE": loss.detach()}, self.mesh)

    @torch.no_grad()
    def val_loss(self, state: TrainState, batch: dict,
                 index: int) -> torch.Tensor:
        """The training objective of the eval-mode model on a prepared
        batch, at draws from (SEED + 23, index); under a mesh the global
        batch's (split where it splits over the ranks, else whole on every
        rank)."""
        model = state.model.eval()
        batch, sharded = shard_batch_or_replicate(batch, self.mesh)
        self._set_batch_group(model, sharded)
        b = self._to_device(batch)
        t, noise = self.draws(self.cfg.SEED + 23, index, b["target"],
                              sharded=sharded)
        loss = self._loss(model, b, t, noise)
        return global_mean({"loss": loss}, self.mesh, sharded)["loss"]

    def ema_model(self, state: TrainState) -> torch.nn.Module:
        """An eval-mode copy of the model holding the EMA weights (rebuilt
        after each train step, on first use); of a sharded model, a whole
        unwrapped copy on every rank."""
        if self._ema_model is None:
            if is_sharded(state.model):
                from torch.distributed.checkpoint.state_dict import (
                    StateDictOptions, get_model_state_dict,
                )

                whole = unpermute_qkv(state.model, get_model_state_dict(
                    state.model,
                    options=StateDictOptions(full_state_dict=True)))
                whole.update(full_ema(state.model, state.ema))
                model = self.build_model(torch.Generator())
                model.load_state_dict(whole)
                model.to(self.device)
            else:
                model = copy.deepcopy(state.model)
                model.load_state_dict(state.ema, strict=False)
            self._ema_model = model.eval()
        return self._ema_model

    @torch.no_grad()
    def sample(self, model: torch.nn.Module, batch: dict, seed: int = 0,
               randn: Optional[Randn] = None) -> torch.Tensor:
        """Conditional hard-DC reconstruction of a batch through the
        `sample_steps` process, DC with the full mask, starting from the
        init image; the noise from a generator seeded with `seed` on the
        trainer's device (or from `randn`). Returns complex
        [N, E, T, Y, X] on the device, unscaled."""
        model = model.eval()
        self._set_batch_group(model, False)     # the whole batch on each rank
        b = self._to_device(self.prepare_batch(batch))
        if randn is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            randn = generator_randn(g)
        kwargs = model_kwargs(b["maps"], b["mask"], b["target"],
                              b["mask_r"])
        return self.diffusion2.p_sample_loop_conditional(
            model, b["init_image"], kwargs, clip_denoised=False, randn=randn)

    def validate(self, state: TrainState, val_loader,
                 writer: Optional[MetricsWriter] = None,
                 recon_metric: Optional[bool] = None) -> Dict[str, float]:
        """Mean validation loss ("Validate MSE"); with recon_metric (by
        default: every EVAL.RECON_SSIM_EVERY_N_EPOCHS epochs) also the
        sampling SSIM of the first batch from the raw and the EMA
        weights."""
        if recon_metric is None:
            every = self.cfg.EVAL.RECON_SSIM_EVERY_N_EPOCHS
            epoch = state.step // self.steps_per_epoch
            recon_metric = bool(every) and epoch % every == 0
        losses, first = [], None
        for i, batch in enumerate(val_loader):
            prepared = self.prepare_batch(batch)
            if i == 0:
                first = prepared
            losses.append(float(self.val_loss(state, prepared, i)))
        out = {"Validate MSE": float(np.mean(losses))}
        if recon_metric and first is not None:
            out.update(self._recon_ssim(state, first))
        if writer is not None:
            writer.scalars(state.step, out)
        logger.info("validate step %d: %s", state.step, out)
        return out

    def _recon_ssim(self, state: TrainState, batch: dict) -> Dict[str, float]:
        """Sampling quality: one validation batch sampled (fixed seed) from
        the raw and the EMA weights, the SSIM of emap 0 frame by frame
        against the batch target. The denoising loss is no proxy for it."""
        from dl_swin_gan_tpu_torch.infer.evaluate import ssim2d

        ref = np.abs(np.asarray(batch["target"]))[:, 0]      # [B, T, Y, X]
        out = {}
        for tag, model in (("", state.model),
                           (" (EMA)", self.ema_model(state))):
            gen = self.sample(model, batch, seed=self.cfg.SEED + 99)
            mag = gen.abs()[:, 0].cpu().numpy()
            vals = []
            for b in range(min(ref.shape[0], mag.shape[0])):
                rng = ref[b].max() - ref[b].min()
                vals.extend(ssim2d(ref[b, t], mag[b, t], data_range=rng)
                            for t in range(ref.shape[1]))
            out[f"Validate recon SSIM{tag}"] = float(np.mean(vals))
        return out

