"""The training cells: `Trainer.train_step` fed by the device pipeline.

Set-up makes a pool of raw slices on the card, builds the program's
`Trainer` and train state, replaces every weight with the benchmark's
seeded draw, and drives the state through its first steps with the
window's own call: per step, the host draws of `DevicePipeline` (crop,
flips, a VDkt mask at 10x to 15x) for `batch` distinct pool slices, their
builds on the card, the stack, and the train step. The window repeats that
call for --seconds on the same state. After the window the reference
follows the first steps from the same weights and raw slices, taking as
its inputs what the program drew in them: the crops, flips and masks, and
the keep decisions of its stochastic depth, recorded at the program's
DropPath modules. Neither side's random streams are replayed.
"""

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import mri, nets, solver
from benchmark.work import sense_normal

LOSS_KEY = "Train/complex_l1"


class Runner:
    unit = "step"

    def __init__(self, cell: harness.Cell, device, seed: int):
        self.cell, self.device, self.seed = cell, device, seed
        self.batch = cell.param("batch")
        self.first = cell.param("first_steps")

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from dl_swin_gan_tpu_torch.data.device_pipeline import DevicePipeline
        from dl_swin_gan_tpu_torch.train import Trainer

        cell, device = self.cell, self.device
        self.cfg = cfg = harness.program_cfg(cell)
        self.precision = harness.trunk_precision(cfg)
        g = cell.geometry
        self.raw_shape = (g["C"], g["T"], g["Y"], g["X"])
        self.pool = traffic.make_slices(cell.param("pool"), g,
                                        harness.derive(self.seed, 1), device)
        self.trainer = Trainer(cfg, device=device)
        self.state = self.trainer.init_state(seed=0)
        named = dict(self.state.model.named_parameters())
        self.shapes = {n: tuple(p.shape) for n, p in named.items()}
        self.fixed = {"step_size": cell.spec["step_size"]}
        self.w0 = weights.draw(self.shapes, harness.derive(self.seed, 2),
                               device, self.fixed)
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(self.w0[n])
        self.pipe = DevicePipeline(cfg, device=device,
                                   draw_seed=harness.derive(self.seed, 3))
        self.order = np.random.RandomState(harness.derive(self.seed, 4))
        self.events = None

        # the check's steps: the window's call on the state it will time
        self.losses, self.draws, self.drops = [], [], []
        self.first_batch = None
        for s in range(self.first):
            with DropRecorder(self.state.model) as drops:
                batch, params, metrics = self.step()
            self.losses.append(metrics[LOSS_KEY].detach().clone())
            self.draws.append(params)
            self.drops.append(drops.decisions())
            if s == 0:
                self.first_batch = {k: v.cpu() for k, v in batch.items()}
                self.grad_norms = self._first_grad_norms()
        self.change_norms = {
            n: float((p.detach() - self.w0[n]).norm())
            for n, p in self.state.model.named_parameters()}
        self.losses = [float(v) for v in self.losses]
        self.sync()

    def _first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's first gradient as Adam got it: its first moment
        after one step over (1 - beta1)."""
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        out = {}
        for n, p in self.state.model.named_parameters():
            st = self.state.optimizer.state.get(p, {})
            out[n] = (float(st["exp_avg"].norm()) / (1 - beta1)
                      if "exp_avg" in st else 0.0)
        return out

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the timed call --------------------------------------------------
    def step(self):
        """One step of the window: draws, builds, stack, train step."""
        rf = torch.profiler.record_function
        idx = self.order.choice(len(self.pool["kspace"]), self.batch,
                                replace=False)
        if self.events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        with rf("bench.draws"):
            params = [self.pipe.draw_params(f"pool_{i}", self.raw_shape)
                      for i in idx]
        with rf("bench.build"):
            built = [self.pipe.build({"kspace": self.pool["kspace"][i:i + 1],
                                      "maps": self.pool["maps"][i:i + 1]}, p)
                     for i, p in zip(idx, params)]
        with rf("bench.stack"):
            batch = {k: torch.cat([b[k] for b in built])
                     for k in self.trainer.batch_keys}
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((start, end))
        with rf("bench.train_step"):
            metrics = self.trainer.train_step(self.state, batch)
        for p, i in zip(params, idx):
            p["pool"] = int(i)
        return batch, params, metrics

    def window(self, seconds: float, events: bool = False) -> Dict:
        self.events = [] if events and self.device.type == "cuda" else None
        self.sync()
        t0 = time.perf_counter()
        steps = 0
        while True:
            self.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        out = {"attempted": steps, "failed": 0, "elapsed": elapsed,
               "unit_s": elapsed / steps,
               "e2e": {"train_samples_per_s": steps * self.batch / elapsed}}
        if self.events:
            out["pipeline_build_ms"] = float(np.mean(
                [a.elapsed_time(b) for a, b in self.events]))
        self.events = None
        return out

    # -- what the per-layer readers need ---------------------------------
    def profile_units(self) -> int:
        return self.cell.param("profile_steps")

    def run_units(self, n: int) -> None:
        self.profiled = [self.step()[1] for _ in range(n)]

    def sense_rows(self) -> List[np.ndarray]:
        """[B, T] acquired rows of each SENSE normal call of the profiled
        steps: one per unroll forward, one in the backward of each unroll
        but the first."""
        calls = 2 * self.cell.spec["num_unrolls"] - 1
        rows = []
        for params in self.profiled:
            r = sense_normal.acquired(np.concatenate([p["mask"]
                                                      for p in params]))
            rows.extend([r] * calls)
        return rows

    def attention_calls(self):
        """(forward calls, backward calls) of the profiled steps, each
        (W, H, N, D, mask): a forward per Swin block and unroll, again in
        the recompute of a rematerialised step, and a backward per block
        and unroll."""
        spec = self.cell.spec
        if spec["trunk"] != "swin":
            return [], []
        blocks = attention_blocks(spec, self.cell.geometry, self.batch,
                                  self.cfg.MODEL.PARAMETERS.NUM_FEATURES)
        remat = 2 if self.cfg.MODEL.PARAMETERS.GRAD_CHECKPOINT else 1
        n = len(self.profiled) * spec["num_unrolls"] * spec["num_swinblocks"]
        return blocks * (n * remat), blocks * n

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("trainer", "state", "pipe", "profiled"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------
    def reference(self, precision: str) -> Dict:
        """The reference's first steps from the same weights and raw
        slices, on the program's draws and stochastic-depth decisions, its
        trunk computed in `precision`."""
        cell, cfg = self.cell, self.cfg
        if cfg.AUG_TRAIN.ZPAD_PE > 0:
            raise NotImplementedError("the reference crops the readout only")
        crop = cfg.AUG_TRAIN.CROP_READOUT
        T, Y = self.raw_shape[1:3]
        X = crop if crop > 0 else self.raw_shape[3]
        batches = []
        for step_draws in self.draws:
            examples = []
            for p in step_draws:
                drawn = dict(xs=int(p["xs"]),
                             flips=[bool(f) for f in np.asarray(p["flips"])],
                             mask=np.asarray(p["mask"]).reshape(T, Y, X))
                examples.append(mri.build_example(
                    self.pool["kspace"][p["pool"]],
                    self.pool["maps"][p["pool"]], drawn, crop))
            batches.append({k: torch.cat([e[k] for e in examples])
                            for k in examples[0]})
        params = {k: v.clone() for k, v in self.w0.items()}
        model = solver.Model(cell.spec, params, nets.Precision(precision))
        trainable = [k for k in self.shapes if k not in self.fixed]
        with solver.ieee_fp32():
            res = solver.train_steps(
                model, batches, trainable, cfg.OPTIMIZER.ADAM.LR,
                cell.param("reference_rows"), self.drops)
        return {"batches": batches, "losses": res["losses"],
                "grad_norms": {k: float(v.norm())
                               for k, v in res["first_grad"].items()},
                "change_norms": {k: float((res["params"][k]
                                           - self.w0[k]).norm())
                                 for k in trainable}}

    def program_side(self) -> Dict:
        return {"batches": [self.first_batch], "losses": self.losses,
                "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}

    def readings(self, side: Dict, ref: Dict) -> Dict[str, float]:
        """The numbers the check compares, `side` (the program, or a
        control) against the reference `ref`; and, printed beside them,
        the spread of the program's draws: the least and largest realised
        acceleration of its masks (samples over acquired samples) and the
        share of flips taken."""
        masks = [np.asarray(p["mask"]) for step in self.draws for p in step]
        accel = [m.size / max(1, int(np.count_nonzero(m))) for m in masks]
        flips = np.concatenate([np.asarray(p["flips"]).reshape(-1) > 0
                                for step in self.draws for p in step])
        build = max(rel_l2(side["batches"][0][k], ref["batches"][0][k])
                    for k in ("kspace", "maps", "mask", "init_image",
                              "target", "scale"))
        loss = max(harness.gap(p, r, 0.0)
                   for p, r in zip(side["losses"], ref["losses"]))
        ref_grad = ref["grad_norms"]
        med_grad = float(np.median(list(ref_grad.values())))
        kept = [k for k, v in ref_grad.items() if v >= 1e-3 * med_grad]
        self.left_out = sorted(set(self.shapes) - set(kept))
        grads = {k: harness.gap(side["grad_norms"].get(k, 0.0), ref_grad[k],
                                med_grad) for k in kept}
        med_change = float(np.median([ref["change_norms"][k] for k in kept]))
        changes = {k: harness.gap(side["change_norms"].get(k, 0.0),
                                  ref["change_norms"][k], med_change)
                   for k in kept}
        self.worst = {
            name: [(k, gaps[k], side[norms].get(k, 0.0), ref[norms][k])
                   for k in sorted(gaps, key=gaps.get, reverse=True)[:3]]
            for name, gaps, norms in (("grad_gap", grads, "grad_norms"),
                                      ("change_gap", changes,
                                       "change_norms"))}
        return {"draw_accel_min": min(accel), "draw_accel_max": max(accel),
                "draw_flip_share": float(flips.mean()), "build_gap": build,
                "loss_gap": loss, "grad_gap": max(grads.values()),
                "change_gap": max(changes.values())}


class DropRecorder:
    """The keep decisions of the program's stochastic depth in one train
    step: forward hooks on its DropPath modules whose rate is above 0 read
    which samples each kept from its output (a dropped sample's branch is
    all zero; one whose input is all zero reads kept, as both give zero).
    A module's first two calls in a step are its block's forward (the
    attention branch, then the MLP's); a rematerialised step calls it
    again in its recompute, and those calls are not kept."""

    def __init__(self, model):
        from dl_swin_gan_tpu_torch.models.swin import DropPath

        self.modules = {n: m for n, m in model.named_modules()
                        if isinstance(m, DropPath) and m.rate > 0}
        self.calls = {n: [] for n in self.modules}
        self.handles = []

    def _hook(self, name):
        def hook(module, inputs, output):
            x, y = inputs[0].detach(), output.detach()
            self.calls[name].append(y.flatten(1).ne(0).any(1)
                                    | x.flatten(1).eq(0).all(1))
        return hook

    def __enter__(self):
        self.handles = [m.register_forward_hook(self._hook(n))
                        for n, m in self.modules.items()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []

    def decisions(self) -> Dict[str, List[torch.Tensor]]:
        """module name -> [attention branch, MLP branch] keep decisions,
        each [B] bool on the host."""
        return {n: [k.cpu() for k in c[:2]] for n, c in self.calls.items()}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.to(b.device).to(b.dtype)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def attention_blocks(spec, geometry, batch: int, features: int):
    """(W, H, N, D, shift mask or None) of each Swin block of one trunk
    forward at this geometry and batch."""
    pad = (2 * spec["num_swinblocks"] + 2) * (3 - 1) // 2
    grid = [-(-(geometry["T"] + 2 * pad) // spec["patch"][0]),
            -(-geometry["Y"] // spec["patch"][1]),
            -(-geometry["X"] // spec["patch"][2])]
    window = spec["window"]
    ws = [min(w, n) for w, n in zip(window, grid)]
    ss = [0 if n <= w else w // 2 for w, n in zip(window, grid)]
    dims = [-(-n // w) * w for n, w in zip(grid, ws)]
    n_windows = int(np.prod([d // w for d, w in zip(dims, ws)]))
    N = int(np.prod(ws))
    heads = spec["heads"]
    mask = nets.shift_mask(dims, ws, ss, "cpu").numpy() \
        if any(ss) else None
    return [(batch * n_windows, heads, N, features // heads,
             mask if j % 2 else None) for j in range(spec["depth"])]
