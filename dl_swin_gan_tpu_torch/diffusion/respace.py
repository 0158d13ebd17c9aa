"""Timestep respacing: `space_timesteps` and `SpacedDiffusion`.

Counterpart of `diffusion/respace.py` in the JAX package: the retained base
timesteps are picked per section (or by the "ddimN" fixed stride), and the
model sees them through `timestep_map` in `_wrap_t`, the hook every model
call of `GaussianDiffusion` goes through.
"""

from typing import Collection, Union

import numpy as np
import torch

from dl_swin_gan_tpu_torch.diffusion.gaussian import GaussianDiffusion


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Collection[int]]) -> set:
    """The base timesteps to retain, including the "ddimN" striding."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {num_timesteps} steps "
                             "with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(
                f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


class SpacedDiffusion(GaussianDiffusion):
    """A base process with steps skipped; the model's timesteps are mapped
    back to the base process's through `timestep_map`."""

    def __init__(self, use_timesteps, **kwargs):
        self.use_timesteps = set(use_timesteps)
        self.timestep_map = []
        self.original_num_steps = len(kwargs["betas"])

        base = GaussianDiffusion(**kwargs)
        last_alpha_cumprod = 1.0
        new_betas = []
        for i, acp in enumerate(base.alphas_cumprod):
            if i in self.use_timesteps:
                new_betas.append(1 - acp / last_alpha_cumprod)
                last_alpha_cumprod = acp
                self.timestep_map.append(i)
        kwargs["betas"] = np.array(new_betas)
        super().__init__(**kwargs)
        self._maps = {}

    def _wrap_t(self, t: torch.Tensor) -> torch.Tensor:
        table = self._maps.get(t.device)
        if table is None:
            with torch.inference_mode(False):
                table = torch.as_tensor(self.timestep_map, dtype=torch.long,
                                        device=t.device)
            self._maps[t.device] = table
        return table[t.long()]
