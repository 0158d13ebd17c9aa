"""Faults planted under the timed path, for the check's own tests and for
reading where a fault lands (`benchmark/calibrate.py`). Each is a context
manager that patches the program while it is active:

  unchanged_state  a train step that computes its loss and gradients and
                   leaves the state as it was (no optimizer update);
  half_batch       a train step on the first half of its batch, the mean
                   taken over that half;
  altered_answer   every served image altered where it is produced: one
                   element moved by a tenth of the image's largest value.
"""

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def unchanged_state():
    from dl_swin_gan_tpu_torch.train.trainer import Trainer

    return _patched(Trainer, "_update",
                    lambda orig: lambda self, *a, **k: None)


def half_batch():
    from dl_swin_gan_tpu_torch.train.trainer import Trainer

    def make(orig):
        def train_step(self, state, batch):
            n = len(next(iter(batch.values())))
            return orig(self, state, {k: v[:max(1, n // 2)]
                                      for k, v in batch.items()})
        return train_step
    return _patched(Trainer, "train_step", make)


def altered_answer():
    from dl_swin_gan_tpu_torch.infer.compact import CompactReconstructor

    def make(orig):
        def call(self, batch):
            out = orig(self, batch)
            out.reshape(-1)[out.size // 2] += 0.1 * abs(out).max()
            return out
        return call
    return _patched(CompactReconstructor, "__call__", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
