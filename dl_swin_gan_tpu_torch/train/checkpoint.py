"""Checkpoints on `torch.save` with best-metric retention and resume.

Counterpart of `train/checkpoint.py` in the JAX package (orbax there; the
reference's Lightning ModelCheckpoint(save_top_k=1, monitor=...)). Each
step is one file `step_<N>.pt` in the directory, and `index.json` keeps the
metrics each step was saved with. Retention is (the best `max_to_keep` by
the monitor) or (the latest step). A metric-less save ranks with the worst
value for the mode (+inf for min, -inf for max), so a periodic save never
outranks a validated one. A metric-bearing save replaces a metric-less one
at the same step; a metric-less re-save of a step is a no-op.

Under a mesh every rank calls `save` (a sharded state is gathered whole
onto rank 0, `train_state.TrainState.state_dict`), rank 0 writes, and every
rank reads on `restore`: the file is the single-device format, so a
checkpoint restores on any number of ranks.
"""

import json
import math
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from dl_swin_gan_tpu_torch.parallel.mesh import is_rank0

_INDEX = "index.json"


def _step_file(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.pt")


def _read_index(directory: str) -> Dict[int, dict]:
    path = os.path.join(directory, _INDEX)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {int(step): metrics for step, metrics in json.load(f).items()}


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, monitor: str = "Validate/complex_l1",
                 mode: str = "min", max_to_keep: int = 1,
                 keep_latest: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = max_to_keep
        self.keep_latest = keep_latest
        self._index = _read_index(self.directory)

    def _value(self, step: int) -> float:
        worst = math.inf if self.mode == "min" else -math.inf
        return self._index[step].get(self.monitor, worst)

    def _ranked(self):
        """Steps from best to worst by the monitor; ties go to the earlier
        step."""
        sign = 1.0 if self.mode == "min" else -1.0
        return sorted(self._index, key=lambda s: (sign * self._value(s), s))

    def all_steps(self):
        return sorted(self._index)

    def save(self, step: int, state: Any,
             metrics: Optional[dict] = None) -> None:
        """Save `state` (its `state_dict()` when it has one) at `step`."""
        step = int(step)
        if step in self._index and metrics is None:
            return
        # a sharded state gathers on every rank and lands on rank 0, which
        # alone writes; every rank keeps the same index
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        writer = is_rank0()
        if writer:
            _atomic_write(_step_file(self.directory, step),
                          lambda tmp: torch.save(payload, tmp))
        self._index[step] = {k: float(v) for k, v in (metrics or {}).items()}
        keep = set(self._ranked()[:self.max_to_keep])
        if self.keep_latest:
            keep.add(max(self._index))
        for old in [s for s in self._index if s not in keep]:
            if writer:
                os.remove(_step_file(self.directory, old))
            del self._index[old]
        index = {str(s): m for s, m in sorted(self._index.items())}

        def write_index(tmp):
            with open(tmp, "w") as f:
                json.dump(index, f)

        if writer:
            _atomic_write(os.path.join(self.directory, _INDEX), write_index)
        if dist.is_initialized():
            dist.barrier()

    def latest_step(self) -> Optional[int]:
        return max(self._index) if self._index else None

    def best_step(self) -> Optional[int]:
        return self._ranked()[0] if self._index else None

    def restore(self, state_like: Any = None, step: Optional[int] = None,
                map_location=None) -> Any:
        """Load `step` (the latest when None). With a `state_like` that has
        `load_state_dict`, load into it and return it; else return what was
        saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint in {self.directory}")
        payload = torch.load(_step_file(self.directory, step),
                             map_location=map_location or "cpu",
                             weights_only=True)
        if hasattr(state_like, "load_state_dict"):
            state_like.load_state_dict(payload)
            return state_like
        return payload
