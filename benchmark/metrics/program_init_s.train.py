"""The trainer's set-up (train/trainer.py): host seconds of `Trainer`
construction and `Trainer.init_state` (the solver built and its weights
drawn), the program's `trainer.construct` and `trainer.init_state` phases
(utils/tracing.py)."""

from benchmark import spans


def read(ctx):
    return spans.phase_s(ctx, ("trainer.construct", "trainer.init_state"))
