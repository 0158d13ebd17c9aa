"""The trainer's optimizer (train/trainer.py, train/train_state.py): the
Adam kernels' device ms per step."""


def read(ctx):
    return ctx.group_ms("adam")
