"""Model FLOPs of a configuration, counted once from its shapes.

`torch.utils.flop_counter.FlopCounterMode` over the reference network
(`benchmark/reference`) on the meta device, so nothing is computed: its
convolutions, their gradients and its matmuls (the Swin linears and the
attention products over all pairs, as the model defines them) at batch 1
without rematerialisation, so that recomputed work is not counted; plus the
SENSE normal operators (`sense_normal.work`) at the traffic's mean
acceleration, which the counter does not see (FFTs). A training step takes
the gradient of the complex-L1 loss with respect to every leaf; serving
runs the forward alone.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets, solver
from benchmark.work import sense_normal


def count(spec: dict, geometry: dict, shapes: dict, train: bool,
          acceleration: float) -> float:
    """FLOP of one example: a train step's forward and backward, or one
    served slice."""
    T, Y, X, C, E = (geometry[k] for k in ("T", "Y", "X", "C", "E"))
    meta = dict(device="meta")
    params = {k: torch.empty(s, **meta) for k, s in shapes.items()}
    y = torch.empty((1, C, T, Y, X), dtype=torch.complex64, **meta)
    maps = torch.empty((1, E, C, 1, Y, X), dtype=torch.complex64, **meta)
    mask = torch.empty((1, 1, T, Y, X), **meta)
    x0 = torch.empty((1, E, T, Y, X), dtype=torch.complex64, **meta)
    model = solver.Model(spec, params, nets.Precision())
    trainable = [k for k in shapes if k != "step_size"]
    with FlopCounterMode(display=False) as counter:
        if train:
            leaves = [params[k].requires_grad_(True) for k in trainable]
            loss = solver.l1(model(y, maps, mask, x0), x0)
            torch.autograd.grad(loss, leaves)
        else:
            with torch.no_grad():
                model(y, maps, mask, x0)
    unrolls = spec["num_unrolls"]
    calls = 2 * unrolls - 1 if train else unrolls
    rows = [[round(Y / acceleration)] * T]
    sense, _ = sense_normal.work(E, C, Y, X, rows)
    return float(counter.get_total_flops() + calls * sense)
