"""Timestep samplers: uniform and loss-second-moment importance sampling.

Counterpart of `diffusion/timestep_sampler.py` in the JAX package. The
loss-aware sampler keeps its history as explicit state (loss_history [T, K],
counts [T]) with functional updates, as there; draws come from an explicit
`torch.Generator`.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from dl_swin_gan_tpu_torch.parallel.mesh import all_gather_batch


class UniformSampler:
    def __init__(self, diffusion):
        self.num_timesteps = diffusion.num_timesteps

    def weights(self) -> np.ndarray:
        return np.ones(self.num_timesteps, np.float64)

    def sample(self, batch_size: int,
               generator: Optional[torch.Generator] = None, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.num_timesteps, (batch_size,),
                          generator=generator, device=device)
        return t, torch.ones((batch_size,), device=device)


class LossSecondMomentResampler:
    """Importance-sample timesteps by sqrt(E[loss^2]) once every timestep
    holds `history_per_term` losses, uniformly before."""

    def __init__(self, diffusion, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = diffusion.num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device=None):
        return (torch.zeros((self.num_timesteps, self.history_per_term),
                            device=device),
                torch.zeros((self.num_timesteps,), dtype=torch.int32,
                            device=device))

    def _warmed_up(self, counts):
        return bool(torch.all(counts == self.history_per_term))

    def weights(self, state) -> torch.Tensor:
        history, counts = state
        if not self._warmed_up(counts):
            return torch.full((self.num_timesteps,), 1.0 / self.num_timesteps,
                              device=history.device)
        w = torch.sqrt(torch.mean(history ** 2, dim=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob \
            / self.num_timesteps

    def sample(self, batch_size: int, state,
               generator: Optional[torch.Generator] = None):
        p = self.weights(state)
        t = torch.multinomial(p, batch_size, replacement=True,
                              generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t])

    def update_with_losses(self, state, ts, losses, group=None):
        """Each per-example loss into its timestep's ring buffer: appended
        while the buffer fills, the oldest dropped once it is full. With a
        process `group` every rank's (t, loss) pairs go in, in rank order,
        so each rank keeps the same history (the JAX package's psum, the
        reference's all_gather)."""
        if group is not None:
            ts, losses = (all_gather_batch(x, group) for x in (ts, losses))
        history, counts = state[0].clone(), state[1].clone()
        for t, loss in zip(ts.tolist(), losses.tolist()):
            c = int(counts[t])
            if c == self.history_per_term:
                history[t] = torch.roll(history[t], -1)
                history[t, -1] = loss
            else:
                history[t, c] = loss
            counts[t] = min(c + 1, self.history_per_term)
        return history, counts
