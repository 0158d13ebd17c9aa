"""DSLR trainer: unrolled low-rank alternating minimisation over (L, R).

Counterpart of `train/dslr_trainer.py` in the JAX package (the reference's
`scripts/train_lr.py`). The preprocess, on the host or on the device, runs
with lr_decom=True (L_init and R_init from a truncated SVD of the
sliding-window init), the BlockOp is built per step from the target's
shape, and the modslr lambdas are logged by the base trainer's
`_extra_metrics`.

The solver runs one example at a time, as the reference does (batch 1);
for B > 1 the trainer loops over the examples and stacks the results, where
the JAX package vmaps the solver. Under a mesh the loop runs over this
rank's slice of the batch, and the CG of each example stays local (the JAX
package's vmapped CG sums per example too).
"""

import torch

from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.ops.llr import BlockOp
from dl_swin_gan_tpu_torch.solvers.dslr import build_dslr_solver
from dl_swin_gan_tpu_torch.train.trainer import Trainer


class DSLRTrainer(Trainer):
    batch_keys = Trainer.batch_keys + ("L_init", "R_init")

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self.block_size = cfg.MODEL.PARAMETERS.DSLR.BLOCK_SIZE
        self.overlapping = cfg.MODEL.PARAMETERS.DSLR.OVERLAPPING

    def build_model(self, generator: torch.Generator) -> torch.nn.Module:
        return build_dslr_solver(self.cfg, generator=generator)

    def _device_pipeline_kwargs(self) -> dict:
        # L_init/R_init from the truncated block SVD on the device
        return {"lr_decom": True}

    def make_preprocess(self, aug_node=None, use_seed=False, draw_seed=None):
        return CinePreprocess(self.cfg, aug_node=aug_node, use_seed=use_seed,
                              lr_decom=True, draw_seed=draw_seed)

    def _apply(self, model, b):
        target = b["target"]
        block_op = BlockOp(self.block_size, (1,) + tuple(target.shape[1:]),
                           overlapping=self.overlapping, device=target.device)
        outs = [model(b["kspace"][i:i + 1], b["maps"][i:i + 1],
                      b["mask"][i:i + 1], b["L_init"][i], b["R_init"][i],
                      block_op) for i in range(target.shape[0])]
        return outs[0] if len(outs) == 1 else torch.cat(outs)
