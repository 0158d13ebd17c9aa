"""Plain PyTorch unrolled PGD, complex-L1 loss and Adam of the reference.

Each unroll takes a gradient step on the data term with the fixed step
size eta, x <- x + eta (A^H A x - A^H y), then that unroll's denoiser. The
training loss is the mean absolute complex error against the fully sampled
SENSE target. Adam is written out (torch.optim's bias-corrected form).
Everything runs in float32 with TF32 off; `Precision` decides how the
trunk rounds its operands (a control).
"""

import contextlib
from typing import Dict, List

import torch

from benchmark.reference import mri, nets


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off for convolutions and matmuls while the reference runs."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class Model:
    """The unrolled network of one configuration (`model` block of its
    file) over a state dict of float32 tensors."""

    def __init__(self, spec: Dict, params: Dict[str, torch.Tensor],
                 prec: nets.Precision):
        self.spec = spec
        self.p = params
        self.prec = prec

    def denoise(self, i: int, x: torch.Tensor, drop) -> torch.Tensor:
        s = self.spec
        prefix = f"nets.{i}."
        if s["trunk"] == "res":
            return nets.res_trunk(x, self.p, prefix, s["num_resblocks"],
                                  self.prec)
        return nets.swin_net(x, self.p, prefix, s["num_swinblocks"],
                             s["depth"], s["heads"], s["window"],
                             s["patch"], self.prec, drop or nets.no_drop)

    def __call__(self, y, maps, mask, x0, drop=None) -> torch.Tensor:
        eta = self.spec["step_size"]
        aty = mri.sense_adjoint(y, maps, mask)
        x = x0
        for i in range(self.spec["num_unrolls"]):
            x = x + eta * (mri.sense_normal(x, maps, mask) - aty)
            x = self.denoise(i, x, drop)
        return x


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (target - pred).abs().mean()


class Adam:
    """Adam on a dict of leaves: m, v and the bias-corrected update."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, g in grads.items():
            m = self.m.setdefault(name, torch.zeros_like(g))
            v = self.v.setdefault(name, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            params[name].addcdiv_(m, denom, value=-self.lr / c1)


def train_steps(model: Model, batches: List[Dict[str, torch.Tensor]],
                trainable: List[str], lr: float, rows: int,
                drops=None) -> Dict:
    """Train `model` on `batches` in turn, one Adam update each. A batch's
    gradient is taken `rows` examples at a time (the loss is a mean over
    equal examples, so the blocks' gradients add with weight rows / B).
    `drops[step]`: that step's stochastic-depth keep decisions
    (`nets.RecordedDrops`), or None. Returns the loss of each step, each
    leaf's first gradient and the parameters after the last step."""
    opt = Adam(lr)
    losses, first_grad = [], None
    for step, b in enumerate(batches):
        n = b["kspace"].shape[0]
        grads = {k: torch.zeros_like(model.p[k]) for k in trainable}
        total = 0.0
        for lo in range(0, n, rows):
            sl = slice(lo, min(n, lo + rows))
            leaves = {k: model.p[k].detach().requires_grad_(True)
                      for k in trainable}
            model.p.update(leaves)
            drop = (None if drops is None
                    else nets.RecordedDrops(drops[step], sl))
            pred = model(b["kspace"][sl], b["maps"][sl], b["mask"][sl],
                         b["init_image"][sl], drop)
            loss = l1(pred, b["target"][sl]) * (sl.stop - sl.start) / n
            got = torch.autograd.grad(loss, [leaves[k] for k in trainable])
            for k, g in zip(trainable, got):
                grads[k] += g
            total += float(loss.detach())
            model.p.update({k: v.detach() for k, v in leaves.items()})
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in grads.items()}
        opt.step(model.p, grads)
        losses.append(total)
    return dict(losses=losses, first_grad=first_grad, params=model.p)


@torch.no_grad()
def serve(model: Model, kspace, maps, mask) -> torch.Tensor:
    """Serving one batch of fully sampled slices: mask, normalise, init,
    reconstruct, and scale back to the input's units."""
    masked = kspace * mask
    y, x0, scale = mri.normalise_and_init(masked, maps)
    return model(y, maps, mask, x0) * scale.reshape(-1, 1, 1, 1, 1)
