"""The compact serving cells: `CompactTransform` and `FlatWire` on host
threads, then the copy, `CompactReconstructor` and the read-back.

A closed loop keeps `in_flight` slices in flight: a request starts with its
host transform (re-undersampling at the cell's acceleration with the
serving protocol's fixed seed, packing the acquired lines, encoding the
flat wire) on one of `threads` host threads; the main thread takes the
requests in order, reconstructs each on the card and reads its image back;
each completion starts the next request. Requests cycle through a pool of
raw slices in an order drawn from the seed. A request's latency runs from
the start of its host transform to its image on the host. Every image
served is kept and, after the window, compared with the reference's image
of its slice.
"""

import gc
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import mri, nets, solver
from benchmark.work import sense_normal

PARITY_SEED = 1000      # the serving protocol's mask seed
WIRE = np.float32       # the flat wire's element type


class Runner:
    unit = "slice"

    def __init__(self, cell: harness.Cell, device, seed: int):
        self.cell, self.device, self.seed = cell, device, seed

    def setup(self) -> None:
        from dl_swin_gan_tpu_torch.infer.compact import (
            CompactReconstructor, CompactTransform, FlatWire, pad_lines,
        )

        cell, device = self.cell, self.device
        self.cfg = cfg = harness.program_cfg(cell)
        self.precision = harness.trunk_precision(cfg)
        g = cell.geometry
        self.frames = g["T"]
        made = traffic.make_slices(cell.param("pool"), g,
                                   harness.derive(self.seed, 1), device)
        self.raw = [(k.cpu().numpy(), m.cpu().numpy())
                    for k, m in zip(made["kspace"], made["maps"])]
        del made
        accel = float(cell.param("acceleration"))
        self.transform = CompactTransform(cfg, acceleration=accel)
        lines = max(self.transform(*r)["line_idx"].shape[-1]
                    for r in self.raw)
        self.n_max = -(-lines // 4) * 4
        self.pad_lines = pad_lines
        template = pad_lines(self.transform(*self.raw[0]), self.n_max)
        self.wire = FlatWire(template, np.dtype(WIRE))
        self.recon = CompactReconstructor(cfg, None, ny=g["Y"],
                                          wire=self.wire, device=device)
        named = dict(self.recon.model.named_parameters())
        self.shapes = {n: tuple(p.shape) for n, p in named.items()}
        self.w0 = weights.draw(self.shapes, harness.derive(self.seed, 2),
                               device, {"step_size": cell.spec["step_size"]})
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(self.w0[n])
        order = np.random.RandomState(harness.derive(self.seed, 4))
        self.order = order.permutation(len(self.raw))
        self.pool = ThreadPoolExecutor(max_workers=cell.param("threads"))
        self.next_request = 0
        self.answers: List = []         # (pool index, image)
        self.loop(cell.param("warm_requests"), keep=False)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def host_side(self, i: int):
        """The host transform of pool slice i: (wire buffer, its ms)."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.host_transform"):
            example = self.pad_lines(self.transform(*self.raw[i]),
                                     self.n_max)
            buf = self.wire.encode(example)[None]
        return buf, (time.perf_counter() - t0) * 1e3

    def loop(self, count=None, seconds=None, keep: bool = True) -> Dict:
        """Serve `count` requests, or as many as start within `seconds`,
        with `in_flight` in flight; returns the latencies and host
        transform times of those that completed inside the window."""
        inflight = deque()

        def submit():
            i = int(self.order[self.next_request % len(self.order)])
            self.next_request += 1
            inflight.append((i, time.perf_counter(),
                             self.pool.submit(self.host_side, i)))

        t0 = time.perf_counter()
        started = 0
        for _ in range(self.cell.param("in_flight")):
            submit()
            started += 1
        done = []
        while inflight:
            i, ts, fut = inflight.popleft()
            buf, host_ms = fut.result()
            with torch.profiler.record_function("bench.reconstruct"):
                image = self.recon(buf)
            td = time.perf_counter()
            done.append((ts - t0, td - t0, host_ms))
            if keep:
                self.answers.append((i, image))
            more = (started < count if count is not None
                    else td - t0 < seconds)
            if more:
                submit()
                started += 1
        return {"done": done, "t0": t0}

    def window(self, seconds: float, events: bool = False) -> Dict:
        self.sync()
        run = self.loop(seconds=seconds)
        inside = [d for d in run["done"] if d[1] <= seconds]
        latencies = [(b - a) * 1e3 for a, b, _ in inside]
        return {"attempted": len(run["done"]), "failed": 0,
                "elapsed": seconds, "unit_s": seconds / max(1, len(inside)),
                "host_transform_ms": float(np.mean([h for *_, h in inside])),
                "e2e": {"serve_frames_per_s":
                        len(inside) * self.frames / seconds,
                        "serve_slice_p95_ms": harness.p95(latencies)}}

    # -- what the per-layer readers need ---------------------------------
    def profile_units(self) -> int:
        return self.cell.param("profile_requests")

    def run_units(self, n: int) -> None:
        self.loop(count=n, keep=False)

    def sense_rows(self) -> List[np.ndarray]:
        """[1, T] acquired rows of each SENSE normal call of the profiled
        slices: one per unroll."""
        g = self.cell.geometry
        aug = self.cfg.AUG_TRAIN.UNDERSAMPLE
        mask = mri.serving_mask((g["T"], g["Y"], g["X"]),
                                float(self.cell.param("acceleration")),
                                PARITY_SEED, aug.PARTIAL_KX, aug.PARTIAL_KY)
        rows = sense_normal.acquired(mask[None])
        n = self.profile_units() * self.cell.spec["num_unrolls"]
        return [rows] * n

    def attention_calls(self):
        return [], []

    def free(self) -> None:
        self.pool.shutdown(wait=True)
        for name in ("recon", "transform", "wire"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------
    def reference(self, precision: str) -> Dict[int, torch.Tensor]:
        """The reference's image of every pool slice that was served."""
        g = self.cell.geometry
        aug = self.cfg.AUG_TRAIN.UNDERSAMPLE
        mask = mri.serving_mask((g["T"], g["Y"], g["X"]),
                                float(self.cell.param("acceleration")),
                                PARITY_SEED, aug.PARTIAL_KX, aug.PARTIAL_KY)
        mask = torch.as_tensor(mask, dtype=torch.float32,
                               device=self.device)[None, None]
        model = solver.Model(self.cell.spec, dict(self.w0),
                             nets.Precision(precision))
        out = {}
        with solver.ieee_fp32():
            for i in sorted({i for i, _ in self.answers}):
                k, m = (torch.as_tensor(a, device=self.device)[None]
                        for a in self.raw[i])
                out[i] = solver.serve(model, k, m, mask)
        return out

    def program_side(self) -> List:
        return self.answers

    def readings(self, side: List, ref: Dict[int, torch.Tensor]
                 ) -> Dict[str, float]:
        """The worst served image against the reference's of its slice:
        relative L2 error, and largest error over the largest magnitude."""
        rel, worst = 0.0, 0.0
        for i, image in side:
            r = ref[i]
            a = torch.as_tensor(image, device=r.device).reshape(r.shape)
            diff = a - r
            rel = max(rel, float(diff.norm() / r.norm()))
            worst = max(worst, float(diff.abs().max() / r.abs().max()))
        return {"answer_rel_l2": rel, "answer_max_err": worst}

    def control_side(self, ref_low: Dict[int, torch.Tensor]) -> List:
        """The control in the program's place: its image for every answer
        the program served."""
        return [(i, ref_low[i].cpu().numpy()) for i, _ in self.answers]
