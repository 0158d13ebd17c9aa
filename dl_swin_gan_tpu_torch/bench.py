"""Headline benchmark of the port: the example-config train step and
reconstruction on one GPU, printed as one JSON line in the format of the
root `bench.py` (`{"metric", "value", "unit", "vs_baseline", ...}`).

    python -m dl_swin_gan_tpu_torch.bench [--device cpu]
    BENCH_WORKLOAD=recon python -m dl_swin_gan_tpu_torch.bench

The workload is `configs/basic/example.yaml` (`utils.headline.headline_cfg`:
5 unrolls x 2 resblocks x 64 features, PGD) on 20x180x64 cine slices with 8
coils and 2 maps, made by `make_cine_example(seed=b)` through
`CinePreprocess(use_seed=True)` and kept resident on the device.

  (default)  unrolled_resnet_train_throughput, samples/s per step (it/s):
             `Trainer.train_step` (complex-L1, Adam) at batch 16 with
             per-unroll remat and the bfloat16 conv trunk (the SENSE
             normal op and data consistency stay float32), against the
             reference's 1.0 it/s at batch 1; the line carries the batch-1
             point (bs1_*, no remat, bf16) and, unless BENCH_DTYPE is set,
             the float32 trunk at batch 16 (f32_*)
  recon      unrolled_resnet_recon_throughput, frames/s of the solver under
             inference mode at batch 4, against the reference's 57 frames/s
  recon_e2e  unrolled_resnet_recon_e2e_throughput: frames/s of serving
             BENCH_SLICES (16) slices one at a time through
             `ResampleTransform(12)` and `Reconstructor`, the host's VDkt,
             normalisation and init included, prefetched on 2 threads, and
             the host-to-device copy; best of BENCH_REPEATS (3)
  recon_e2e_compact  the same over the acquired-lines wire
             (`infer/compact.py`): BENCH_WIRE flat (one float32 buffer a
             slice, the default), dict or flat16 (one float16 buffer):
             unrolled_resnet_recon_e2e_compact[_dict|_flat16]_throughput
  recon_e2e_wire  the three wires interleaved in one process, one line each

The end-to-end lines carry `wire_mb_per_slice`, the bytes a slice copies to
the device, and are timed as the root bench.py times them: each slice's
result read back as it comes, the clock stopped after the last.

Environment: BENCH_BATCH pins one explicit batch (remat when it exceeds 1,
or with BENCH_REMAT), BENCH_DTYPE the trunk dtype (float32 | bfloat16),
BENCH_ITERS and BENCH_REPEATS the timing (best of 6 repeats of 20 chained
steps, each repeat ended by `torch.cuda.synchronize()`), BENCH_SHAPE
"T,Y,X,C" the slice and BENCH_OPTS "KEY VALUE ..." config overrides (both
for tests at a reduced size).

`tflops` and `mfu` count FLOPs with `torch.utils.flop_counter.FlopCounterMode`
over one step (convolutions and matmuls) plus the SENSE-normal kernel's
analytic count (`kernels.sense_normal.normal_work`), which the counter does
not see, against the H100's dense peak for the trunk dtype: 989 TFLOP/s in
bfloat16, 67 TFLOP/s in float32 (TF32 is off). The line names the card and
its power limit. It runs on the GPU unless --device cpu is given, and raises
without one.
"""

import argparse
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.kernels.sense_normal import normal_work
from dl_swin_gan_tpu_torch.utils.device import resolve_device
from dl_swin_gan_tpu_torch.utils.headline import headline_cfg, headline_shape

HEADLINE_BATCH = 16          # slices per headline train step
BASELINE_IT_S = 1.0          # the reference's committed bs=1 training rate
BASELINE_RECON_FPS = 2.85 * 20   # its validation rate: 2.85 it/s x 20 frames
# NVIDIA H100 SXM dense peaks (data sheet) by trunk dtype; float32 runs on
# the FMA pipes, since TF32 is off
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLOP_SOURCE = ("torch.utils.flop_counter.FlopCounterMode (convs, matmuls) "
               "+ analytic SENSE-normal count (kernels.sense_normal."
               "normal_work)")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def card(device: torch.device) -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    if device.type != "cuda":
        return {"device": str(device), "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    index = device.index or 0
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": smi[index].split(",")[-1].strip()}


def slice_shape():
    """(T, Y, X, C, E): the headline slice, or BENCH_SHAPE's T,Y,X,C."""
    T, Y, X, C, E = headline_shape()
    if os.environ.get("BENCH_SHAPE"):
        T, Y, X, C = (int(v) for v in os.environ["BENCH_SHAPE"].split(","))
    return T, Y, X, C, E


def bench_cfg(dtype: str, remat: bool = False):
    """The headline config with the trunk dtype, remat and BENCH_OPTS."""
    cfg = headline_cfg(output_dir="runs/bench")
    cfg.MODEL.RECON_LOSS.NAME = "complex_l1"
    cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    cfg.MODEL.PARAMETERS.GRAD_CHECKPOINT = remat
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = dtype
    if os.environ.get("BENCH_OPTS"):
        cfg.merge_from_list(os.environ["BENCH_OPTS"].split())
    cfg.freeze()
    return cfg


def device_batch(cfg, B: int, device) -> dict:
    """B preprocessed slices (seeds 0..B-1), stacked, on the device."""
    T, Y, X, C, E = slice_shape()
    pre = CinePreprocess(cfg, use_seed=True)
    exs = [pre(*make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=b),
               f"bench_{b}") for b in range(B)]
    return {k: torch.from_numpy(np.stack([e[k] for e in exs])).to(device)
            for k in exs[0]}


def sense_flops(batch: dict, launches: int) -> float:
    """FLOP of `launches` SENSE-normal calls on this batch's mask."""
    E, C = batch["maps"].shape[1:3]
    w = batch["mask"][:, 0] * batch["mask"][:, 0]
    dft, other, _ = normal_work(E, C, w)
    return float(launches * (dft + other))


def counted_flops(fn, batch: dict, sense_launches: int) -> float:
    """FLOP of one fn() call: FlopCounterMode's count plus the SENSE
    kernel's, which it does not see."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() + sense_flops(batch, sense_launches)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_seconds(fn, device, iters: int, repeats: int) -> float:
    """Best over `repeats` of the time of `iters` chained fn() calls, each
    repeat ended by a device synchronize."""
    best = float("inf")
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


class TrainStep:
    """The example-config train step through `Trainer.train_step` on a batch
    resident on the device: seeded torch-default weights, Adam."""

    def __init__(self, B: int, remat: bool, dtype: str, device):
        from dl_swin_gan_tpu_torch.train import Trainer

        self.cfg = bench_cfg(dtype, remat)
        self.trainer = Trainer(self.cfg, device=device)
        self.batch = device_batch(self.cfg, B, self.trainer.device)
        self.state = self.trainer.init_state(seed=0)
        self.sense_launches = sense_launches_per_step(self.cfg)

    def __call__(self):
        return self.trainer.train_step(self.state, self.batch)


def sense_launches_per_step(cfg) -> int:
    """SENSE-normal launches of one train step, from the code: one per
    unroll forward, and one in the backward of every unroll but the first,
    whose input needs no gradient (remat recomputes the denoisers only)."""
    return 2 * cfg.MODEL.PARAMETERS.NUM_UNROLLS - 1


def measure_train(B: int, remat: bool, dtype: str, device) -> dict:
    """One train-step point: samples/s, FLOP per step, seconds per step and
    peak device memory."""
    step = TrainStep(B, remat, dtype, device)
    for _ in range(3):                      # warm-up: cuDNN, allocator
        step()
    flops = counted_flops(step, step.batch, step.sense_launches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    iters = _env_int("BENCH_ITERS", 20)
    best = best_seconds(step, device, iters, _env_int("BENCH_REPEATS", 6))
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    return dict(samples_per_s=iters * B / best, flops=flops,
                dt=best / iters, peak_mem_gb=peak)


def measure_recon(B: int, dtype: str, device) -> dict:
    """Reconstruction of a resident batch of B slices: frames/s."""
    from dl_swin_gan_tpu_torch.convert import init_params
    from dl_swin_gan_tpu_torch.infer import Reconstructor

    cfg = bench_cfg(dtype)
    recon = Reconstructor(cfg, init_params(cfg, 0), device)
    b = device_batch(cfg, B, recon.device)

    @torch.inference_mode()
    def run():
        return recon.model(b["kspace"], b["maps"], b["mask"],
                           x0=b["init_image"])

    run()
    run()
    flops = counted_flops(run, b, cfg.MODEL.PARAMETERS.NUM_UNROLLS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    iters = _env_int("BENCH_ITERS", 20)
    best = best_seconds(run, device, iters, _env_int("BENCH_REPEATS", 6))
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    T = slice_shape()[0]
    return dict(fps=iters * B * T / best, flops=flops, dt=best / iters,
                peak_mem_gb=peak)


# the end-to-end workloads: the parity protocol's acceleration; their
# variants, the dense path and the compact wires
E2E_ACCEL = 12.0
E2E_WIRES = ("dict", "flat", "flat16")


class E2EVariant(NamedTuple):
    """One end-to-end serving variant: `make_input` runs the host side of a
    raw slice (kspace, maps), `recon` the copy and the device side."""
    name: str
    make_input: Callable
    recon: Callable
    mb_per_slice: float

    @property
    def metric(self) -> str:
        if self.name == "dense":
            return "unrolled_resnet_recon_e2e_throughput"
        suffix = "" if self.name == "flat" else f"_{self.name}"
        return f"unrolled_resnet_recon_e2e_compact{suffix}_throughput"


def e2e_variants(wanted, device):
    """(T, the raw slices, [E2EVariant]) for the variants `wanted` ("dense"
    and the names of E2E_WIRES) on BENCH_SLICES slices, all with one set of
    seeded weights. The compact wires share one line budget: the most
    lines any frame of the set acquires, rounded up to a multiple of 4."""
    from dl_swin_gan_tpu_torch.convert import init_params
    from dl_swin_gan_tpu_torch.infer import Reconstructor, ResampleTransform
    from dl_swin_gan_tpu_torch.infer.compact import (
        CompactReconstructor, CompactTransform, FlatWire, pad_lines,
        wire_bytes,
    )

    cfg = bench_cfg(os.environ.get("BENCH_DTYPE", "float32"))
    T, Y, X, C, E = slice_shape()
    raw = [make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=s)[:2]
           for s in range(_env_int("BENCH_SLICES", 16))]
    params = init_params(cfg, 0)
    variants = []
    if "dense" in wanted:
        dense = ResampleTransform(E2E_ACCEL, cfg)

        def dense_input(r):
            return {k: np.asarray(v)[None] for k, v in dense(*r).items()}
        variants.append(E2EVariant(
            "dense", dense_input, Reconstructor(cfg, params, device),
            wire_bytes(dense(*raw[0])) / 1e6))
    wires = [w for w in wanted if w != "dense"]
    if wires:
        compact = CompactTransform(cfg, acceleration=E2E_ACCEL)
        probe = [compact(*r) for r in raw]
        n_max = -(-max(p["line_idx"].shape[-1] for p in probe) // 4) * 4
        template = pad_lines(probe[0], n_max)
    for name in wires:
        if name == "dict":
            wire, mb = None, wire_bytes(template) / 1e6

            def make(r, _n=n_max):
                return {k: np.asarray(v)[None]
                        for k, v in pad_lines(compact(*r), _n).items()}
        else:
            wire = FlatWire(template, np.float16 if name == "flat16"
                            else np.float32)
            mb = wire.length * wire.dtype.itemsize / 1e6

            def make(r, _n=n_max, _w=wire):
                return _w.encode(pad_lines(compact(*r), _n))[None]
        variants.append(E2EVariant(
            name, make, CompactReconstructor(cfg, params, ny=Y, wire=wire,
                                             device=device), mb))
    return T, raw, variants


def e2e_seconds(raw, variant: E2EVariant) -> float:
    """Seconds to serve every raw slice through `variant`, the host side
    prefetched on 2 threads (the timing of the root bench.py and of the
    reference's scripts/reconstruct.py:211-240)."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(variant.make_input, r) for r in raw]
        t0 = time.perf_counter()
        out = [variant.recon(f.result()) for f in futs]
        _ = np.asarray(out[-1]).ravel()[0]
        return time.perf_counter() - t0


def measure_e2e(wanted, device) -> tuple:
    """(T, raw slices, variants, {name: best seconds}): one warm-up call of
    each variant, then BENCH_REPEATS rounds, each variant once a round,
    in turn."""
    T, raw, variants = e2e_variants(wanted, device)
    for v in variants:
        v.recon(v.make_input(raw[0]))
    best = {v.name: float("inf") for v in variants}
    for _ in range(_env_int("BENCH_REPEATS", 3)):
        for v in variants:
            best[v.name] = min(best[v.name], e2e_seconds(raw, v))
    return T, raw, variants, best


def bench_e2e(device, wanted) -> list:
    """One line per end-to-end variant in `wanted`."""
    T, raw, variants, best = measure_e2e(wanted, device)
    return [emit(v.metric, round(len(raw) * T / best[v.name], 1),
                 "frames/s", BASELINE_RECON_FPS, {
                     "wire_mb_per_slice": round(v.mb_per_slice, 4),
                     "slices": len(raw), "acceleration": E2E_ACCEL,
                     **card(device)})
            for v in variants]


def rates(flops: float, dt: float, dtype: str, device,
          prefix: str = "") -> dict:
    """Achieved TFLOP/s and the share of the H100's peak: card numbers, so
    null on any other device."""
    if device.type != "cuda":
        return {f"{prefix}tflops": None, f"{prefix}mfu": None}
    tflops = flops / dt / 1e12
    return {f"{prefix}tflops": round(tflops, 2),
            f"{prefix}mfu": round(tflops * 1e12 / PEAK_FLOPS[dtype], 4)}


def emit(metric: str, value: float, unit: str, baseline: float,
         extra: dict) -> dict:
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": round(value / baseline, 3)}
    rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def bench_train(device) -> dict:
    dtype = os.environ.get("BENCH_DTYPE") or None
    if os.environ.get("BENCH_BATCH"):
        # an explicit operating point: exactly what was asked
        B = int(os.environ["BENCH_BATCH"])
        remat = B > 1 or bool(os.environ.get("BENCH_REMAT"))
        dtype = dtype or "float32"
        m = measure_train(B, remat, dtype, device)
        return emit("unrolled_resnet_train_throughput",
                    round(m["samples_per_s"], 3), "it/s", BASELINE_IT_S, {
                        "batch": B, "remat": remat, "trunk_dtype": dtype,
                        **rates(m["flops"], m["dt"], dtype, device),
                        "peak_mem_gb": m["peak_mem_gb"],
                        "flop_source": FLOP_SOURCE, **card(device)})

    # the headline: batch 16 with remat, bf16 trunk, per-sample throughput;
    # the batch-1 point (no remat) and, unless BENCH_DTYPE pins the trunk,
    # the float32 trunk ride the same line
    pinned, dtype = dtype is not None, dtype or "bfloat16"
    head = measure_train(HEADLINE_BATCH, True, dtype, device)
    extra = {"batch": HEADLINE_BATCH, "remat": True, "trunk_dtype": dtype,
             **rates(head["flops"], head["dt"], dtype, device),
             "peak_mem_gb": head["peak_mem_gb"]}
    bs1 = measure_train(1, False, dtype, device)
    extra["bs1_it_s"] = round(bs1["samples_per_s"], 3)
    extra.update(rates(bs1["flops"], bs1["dt"], dtype, device, "bs1_"))
    if not pinned:
        f32 = measure_train(HEADLINE_BATCH, True, "float32", device)
        extra["f32_samples_per_s"] = round(f32["samples_per_s"], 3)
        extra.update(rates(f32["flops"], f32["dt"], "float32", device,
                           "f32_"))
        extra["f32_peak_mem_gb"] = f32["peak_mem_gb"]
    extra.update(flop_source=FLOP_SOURCE, **card(device))
    return emit("unrolled_resnet_train_throughput",
                round(head["samples_per_s"], 3), "it/s", BASELINE_IT_S, extra)


def bench_recon(device) -> dict:
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    B = _env_int("BENCH_BATCH", 4)
    m = measure_recon(B, dtype, device)
    return emit("unrolled_resnet_recon_throughput", round(m["fps"], 1),
                "frames/s", BASELINE_RECON_FPS, {
                    "batch": B, "trunk_dtype": dtype,
                    **rates(m["flops"], m["dt"], dtype, device),
                    "peak_mem_gb": m["peak_mem_gb"],
                    "flop_source": FLOP_SOURCE, **card(device)})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when not given")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    workload = os.environ.get("BENCH_WORKLOAD", "")
    if workload == "recon":
        return bench_recon(device)
    e2e = {"recon_e2e": ["dense"],
           "recon_e2e_compact": [os.environ.get("BENCH_WIRE", "flat")],
           "recon_e2e_wire": list(E2E_WIRES)}
    if workload in e2e:
        wires = e2e[workload]
        if not set(wires) <= {"dense", *E2E_WIRES}:
            raise ValueError(f"BENCH_WIRE={wires[0]!r}: one of {E2E_WIRES}")
        return bench_e2e(device, wires)
    if workload:
        raise ValueError(f"BENCH_WORKLOAD={workload!r}: the port benches the "
                         "default train step, 'recon' and " + ", ".join(e2e))
    return bench_train(device)


if __name__ == "__main__":
    main()
