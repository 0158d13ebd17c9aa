#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's reconstruction and training paths once on one
GPU and check them.

    python3 chip_smoke.py

Phases, each on lines of its own; any failed check raises, and the script
then exits non-zero and prints no result:

  1. device   the card's name and power limit (nvidia-smi), the torch and CUDA
              versions, and the two TF32 flags (both off: true float32)
  2. build    compile every kernel of the paths from kernels/csrc, one nvcc
              per source, all started together; ptxas registers and spills
              (none allowed in any of them: their tensor-core products
              hold split operands in registers)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes (batch 1 and 4, and 16 for the SENSE
              normal op: the headline train step's; window attention, forward
              and backward, with and without the shift mask; the block-LLR
              normal op, 'pre' and 'post', one and two systems), with its
              time, the plain version's, the PyTorch library call's, and its
              bound (at the 3xTF32 tensor-core rate, with the fp32-FMA
              figure beside it; their device times by launch from
              torch.profiler); the coil pass's blocks per SM at 180x64 (two
              at least) and the attention forward's at full width; the
              backwards and the block-LLR op also called twice for
              bitwise-equal results
  4. main     the headline config (configs/basic/example.yaml: 5 unrolls x 2
              resblocks x 64 features, float32, seeded torch-default weights)
              on 4 synthetic 20x180x64 slices with 8 coils and 2 maps, through
              ResampleTransform(12) and Reconstructor on cuda, at batch 1 and
              batch 4; the kernel launches are counted, one slice's device
              time is split by kernel group (torch.profiler), and one slice
              is held against the port's own CPU path
  5. swin     the same for configs/config_swin.yaml (5 unrolls x 1 swinblock
              x 160 features, depths (6,), 8 heads, window (7, 8, 8), patch
              (4, 4, 4), float32): 30 window-attention and 5 SENSE-normal
              launches per batch
  6. train    config_swin.yaml's training path through Trainer on cuda:
              seeded torch-default weights, full-width slices made by
              make_cine_example (readout 96, cropped to 64) through
              CinePreprocess and DataLoader in memory, a few Adam steps at
              batch 1 with stochastic depth and remat on; per step 60
              window-attention (30 and 30 recomputed), 30 backward and 9
              SENSE-normal launches (5 forward, 4 backward). One step's device
              time by kernel group; one step held against the port's CPU
              path at 1 unroll (full width); a checkpoint reloaded into
              Reconstructor against the trainer's val_step
  7. dslr     configs/config_dslr.yaml (dslr-cg-v1: 5 unrolls x 2 factor
              solves x 10 CG steps, 8 basis vectors per 16x16 block, 2D and
              1D complex ResNets of 2 x 64 features) through DSLRTrainer on
              cuda: slices through CinePreprocess(lr_decom=True) and
              DataLoader, 1 warm-up and 4 timed Adam steps; per step 110
              'pre' and 88 'post' block-LLR normal launches, asserted; one
              step's device time by kernel group; val_step; one step and one
              val_step at 2 unrolls held against the port's CPU path; one
              val_step of the dslr-cg-jacobi mode (6 CG steps): 35 launches
              of both factor systems (S=2)
  8. headline the RES main path closed: the port bench's train step
              (dl_swin_gan_tpu_torch.bench, Trainer.train_step on a resident
              batch) at batch 16 with remat in bfloat16 and float32 and at
              batch 1 in bfloat16, 1 warm-up and 3 timed steps each, 9
              SENSE-normal launches per step asserted, peak memory, one
              step's device time by kernel group; one bfloat16 step at 1
              unroll held against the port's CPU bfloat16 step; main's 4
              slices served with the bfloat16 trunk and scored by the
              port's evaluator (SSIM, PSNR) against their 1x adjoint; a CFL
              round trip through reconstruct_cfl against Reconstructor
  9. se       configs/config_se.yaml (5 unrolls x 1 resblock x 384
              features, SE gate of hidden width 16) served like main (5
              SENSE-normal launches per batch), the CPU comparison at 1
              unroll; 1 warm-up and 3 timed Trainer steps at its readout
              crop of 48 (9 SENSE-normal launches per step), one step at 1
              unroll held against the port's CPU step; the CBAM trunk served
              at configs/quality/cbam.yaml's widths (1 x 96 features)
 10. modl     the example config with META_ARCHITECTURE modl (the hqs rule,
              10 CG steps per unroll) served like main: 5 x (1 + 10) = 55
              SENSE-normal launches per batch, and the SENSE kernel's share
              of a slice's device time (printed for every served path)
 11. gan      configs/config_swingan.yaml through GANTrainer: the Swin
              generator (remat, stochastic depth) and the PatchGAN
              discriminator, 1 warm-up and 3 timed steps at batch 1 (60
              window-attention, 30 backward and 9 SENSE-normal launches per
              step, one generator forward), the discriminator, adversarial
              and reconstruction losses, one step's device time by group
              with the discriminator as its own; val_step and the GAN
              checkpoint served through Reconstructor; one step at 1 unroll,
              stochastic depth off, held against the port's CPU step
 12. pipeline the device-resident input pipeline (data/device_pipeline.py)
              at the quality set's geometry (18x156x96 slices, 8 coils, 2
              maps, readout cropped to 64) and configs/quality/se.yaml's
              widths: (a) one seeded build on the card against the host
              CinePreprocess of the same slice (masks bit for bit, the
              rest within the JAX package's pipeline-test tolerances); (b)
              the same with lr_decom at config_dslr.yaml's 16x16 blocks and
              8 basis vectors, L R^H compared, the batched SVD timed; (c)
              PIPE_STEPS timed Trainer steps fed by each loader, the host
              DataLoader and the pipeline, with the float32 trunk and a
              bfloat16 one: steps/s, the device's busy share, 9
              SENSE-normal launches per step asserted
 13. result   one JSON line of kernels, then the last line
              {"ok": true, "device": {...}}

Needs one CUDA device, nvcc and this checkout; no network, no JAX.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from dl_swin_gan_tpu_torch import bench
from dl_swin_gan_tpu_torch.convert import init_params
from dl_swin_gan_tpu_torch.data import (
    CinePreprocess, DataLoader, cfl,
)
from dl_swin_gan_tpu_torch.data.device_pipeline import (
    DevicePipeline, DevicePipelineLoader,
)
from dl_swin_gan_tpu_torch.data.host_ops import fftmod
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, quality_split,
)
from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_volumes
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    Reconstructor, accel_transform, batched, load_checkpoint_params,
    reconstruct_cfl, reconstruct_examples,
)
from dl_swin_gan_tpu_torch.infer.transforms import (
    PARITY_SEED, InferenceTransform, ResampleTransform,
)
from dl_swin_gan_tpu_torch.kernels import _build
from dl_swin_gan_tpu_torch.kernels import llr_normal as LN
from dl_swin_gan_tpu_torch.kernels import sense_normal as SN
from dl_swin_gan_tpu_torch.kernels import window_attn as WA
from dl_swin_gan_tpu_torch.models.swin import compute_shift_mask
from dl_swin_gan_tpu_torch.ops.llr import BlockOp, compose, decompose
from dl_swin_gan_tpu_torch.ops.masks import VDktMaskFunc
from dl_swin_gan_tpu_torch.ops.sense import _adjoint_impl, _forward_impl
from dl_swin_gan_tpu_torch.models.swin import DropPath
from dl_swin_gan_tpu_torch.train import (
    CheckpointManager, DSLRTrainer, GANTrainer, Trainer,
)
from dl_swin_gan_tpu_torch.utils.device import use_ieee_fp32
from dl_swin_gan_tpu_torch.utils.headline import (
    dslr_cfg, headline_cfg, headline_shape, quality_cfg, se_cfg, swin_cfg,
    swingan_cfg,
)

ACCEL = 12
SLICES = 4
SEED = 0
KERNEL_REL_TOL = 1e-4     # TF32 in a DFT pass would show as ~1e-3
KERNELS = ("sense_normal", "window_attn", "window_attn_bwd", "llr_normal")
# each kernel's launch counter: the wrapper whose `launches` counts them, and
# the variant's key where that is a dict
COUNTERS = {"sense_normal": (SN.sense_normal, None),
            "window_attention": (WA.window_attention, None),
            "window_attention_bwd": (WA.window_attention_bwd, None),
            "llr_normal_pre": (LN.llr_normal, "pre"),
            "llr_normal_post": (LN.llr_normal, "post")}
# the Swin block at full width: (20 + 2 * 4 padded) frames / 4 = 7, 180 / 4
# = 45 rows padded to 48, 64 / 4 = 16 columns; 12 windows of (7, 8, 8), shift
# (0, 4, 4)
SWIN_GRID, SWIN_WINDOW, SWIN_SHIFT = (7, 48, 16), (7, 8, 8), (0, 4, 4)
SWIN_HEADS, SWIN_HEAD_DIM = 8, 20
CPU_REL_L2_TOL = 1e-3     # fp32 GPU (cuDNN, kernel) vs fp32 CPU, 5 unrolls
TIMING_RUNS = 30
# the train phase: slices of readout RAW_X (cropped to 64 by CROP_READOUT),
# one warm-up step, then TRAIN_STEPS timed steps
RAW_X = 96
TRAIN_STEPS = 4
TRAIN_LOSS_REL_TOL = 1e-4     # GPU vs CPU train step, 1 unroll
TRAIN_GRAD_REL_L2_TOL = 1e-3
RUNS = Path(__file__).resolve().parent / "runs" / "chip_smoke"
# the dslr phase: the unrolls of the step held against the CPU path, and the
# jacobi mode's CG steps (configs/quality/dslr_fast.yaml)
DSLR_CUT_UNROLLS = 2
JACOBI_CG_STEPS = 6
# the headline phase: the bench's train step at (batch, remat, trunk dtype),
# one warm-up and HEADLINE_STEPS timed steps each
HEADLINE_POINTS = ((bench.HEADLINE_BATCH, True, "bfloat16"),
                   (bench.HEADLINE_BATCH, True, "float32"),
                   (1, False, "bfloat16"))
HEADLINE_STEPS = 3
# a bfloat16 step on the card vs the CPU's bfloat16 step at 1 unroll, and
# bfloat16 serving vs the CPU: both round each conv's input, kernel and
# output to bfloat16, but accumulate in other orders, so a few outputs round
# the other way (2^-8 relative each). The H100 showed loss rel 2.8e-6,
# gradient rel L2 8.4e-4 and serving rel L2 1.7e-3; the limits keep a
# margin of 6x to 10x
BF16_LOSS_REL_TOL = 3e-5
BF16_GRAD_REL_L2_TOL = 5e-3
BF16_REL_L2_TOL = 1e-2
# the se phase: config_se.yaml's 384 features cost about 5 TFLOP per unroll
# on the CPU, so the CPU comparisons run 1 unroll at full width (the H100's
# host took 8.1 s to serve and 18.5 s to train it); SE_TRAIN_STEPS timed
# steps
SE_CPU_UNROLLS = 1
SE_TRAIN_STEPS = 3
# the gan phase: timed steps, and the losses it reads
GAN_STEPS = 3
GAN_KEYS = ("Train/disc_loss", "Train/adv_loss", "Train/complex_l1")
# the pipeline phase: the quality set's first PIPE_FILES train files (4
# slices each), PIPE_WARMUP untimed and PIPE_STEPS timed Trainer steps per
# loader, then PIPE_PROFILE_STEPS profiled ones; the device build in
# complex64 against the host's complex128 CinePreprocess to the JAX package's
# tests/test_device_pipeline.py tolerances (its L R^H: the SVD's sums in
# other orders)
PIPE_FILES = 3
PIPE_WARMUP = 2
PIPE_STEPS = 20
PIPE_PROFILE_STEPS = 5
PIPE_RTOL = 2e-4
PIPE_SCALE_RTOL = 1e-4
PIPE_LR_RTOL = 2e-3
# reconstruct_cfl vs Reconstructor on the same scanner arrays: the same
# inputs through the same solver
CFL_REL_L2_TOL = 1e-6
# published H100 SXM peaks (NVIDIA data sheet) for the bound
FP32_FLOPS = 67e12        # float32 outside the tensor cores
TF32_FLOPS = 495e12       # dense TF32 on the tensor cores; 3xTF32 runs at 1/3
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def zero_counts():
    """Set every kernel's launch counter to 0."""
    for fn, key in COUNTERS.values():
        if key is None:
            fn.launches = 0
        else:
            fn.launches[key] = 0
    LN.llr_normal.systems = dict.fromkeys(LN.llr_normal.systems, 0)


def read_counts():
    """{counter: launches since the last zero_counts()}."""
    return {name: fn.launches if key is None else fn.launches[key]
            for name, (fn, key) in COUNTERS.items()}


def cuda_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median device time of fn() in ms, by CUDA events; L2 flushed before
    each call, since on the main path the conv trunk evicts the inputs."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    use_ieee_fp32()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        libs = dict(zip(KERNELS, pool.map(_build.load, KERNELS)))
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"build {name}: nvcc {lib.build_seconds:.2f} s "
              f"-> {lib.path.parent.name}")
        for ln in lib.log.splitlines():
            entry = re.search(r"entry function '([^']+)'", ln)
            if entry:       # the mangled name carries the template argument
                print(f"  ptxas: {entry.group(1)}")
            elif "registers" in ln or "spill" in ln:
                print(f"  ptxas: {ln.strip()}")
    # the tensor-core attention kernels hold their split operands in
    # registers, and the coil pass runs two blocks per SM, which caps its
    # registers
    for name in ("sense_normal", "window_attn", "window_attn_bwd",
                 "llr_normal"):
        spills = [ln.strip() for ln in libs[name].log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in ln]
        check(not spills, f"{name} spills registers: {spills}")


def _coil_bound(dft, other, nbytes):
    """The bound of a call whose coil-pass DFTs run 3xTF32 on the tensor
    cores (TF32_FLOPS / 3) and the rest as float32 FMA, against its bytes;
    with the float32-FMA figure for all of it beside it."""
    t_ops = (dft / (TF32_FLOPS / 3) + other / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops_ms=t_ops, bytes_ms=t_bytes,
                fma_bound_ms=max((dft + other) / FP32_FLOPS * 1e3, t_bytes),
                gflop=(dft + other) / 1e9, mbytes=nbytes / 1e6)


def phase_kernels():
    return {"sense_normal": kernels_sense_normal(),
            "window_attention": kernels_window_attention(),
            "window_attention_bwd": kernels_window_attention_bwd(),
            "llr_normal": kernels_llr_normal()}


def sense_inputs(rng, B):
    """The SENSE-normal kernel's inputs at the headline shape, batch B, on
    the 12x parity mask: x, maps, w and the operator chain's maps6, m5."""
    T, Y, X, C, E = headline_shape()
    mask = VDktMaskFunc((ACCEL, ACCEL))((1, 1, T, Y, X), PARITY_SEED)[0, 0]

    def c64(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.complex64)).cuda()

    x = c64(B, E, T, Y, X)
    maps = c64(B, E, C, Y, X)
    m5 = torch.from_numpy(np.broadcast_to(mask, (B, 1, T, Y, X)).copy()).cuda()
    w = (m5[:, 0] * m5[:, 0]).contiguous()
    return x, maps, w, maps.unsqueeze(3), m5


def coil_launches(fn):
    """{kernel: device ms per fn() call} of the coil-pass launches."""
    return {_short(n): t for n, t in device_ms_by_kernel(fn).items()
            if "coil_" in n}


def kernels_sense_normal():
    """sense_normal kernel vs plain vs the cuFFT chain at batch 1 and 4, and
    at the headline train step's batch 16."""
    T, Y, X, C, E = headline_shape()
    blocks = SN.blocks_per_sm(Y, X)
    print(f"kernel sense_normal: coil_normal_kernel blocks per SM at {Y}x{X}: "
          f"{blocks}")
    check(blocks >= 2, f"coil_normal_kernel fits {blocks} block(s) per SM")
    rng = np.random.RandomState(SEED)
    results = {}
    for B in (1, 4, bench.HEADLINE_BATCH):
        x, maps, w, maps6, m5 = sense_inputs(rng, B)
        out = SN.sense_normal(x, maps, w)
        plain = SN.sense_normal_plain(x, maps, w)
        library = _adjoint_impl(_forward_impl(x, maps6, m5), maps6, m5)
        torch.cuda.synchronize()
        scale = plain.abs().max().item()
        max_abs = (out - plain).abs().max().item()
        rel = max_abs / scale
        lib_rel = (library - plain).abs().max().item() / scale
        check(torch.isfinite(torch.view_as_real(out)).all().item(),
              f"kernel output not finite at B={B}")
        check(rel <= KERNEL_REL_TOL,
              f"kernel vs plain rel err {rel:.3e} > {KERNEL_REL_TOL} at B={B}")
        check(lib_rel <= KERNEL_REL_TOL,
              f"cuFFT chain vs plain rel err {lib_rel:.3e} at B={B}")

        ms = cuda_ms(lambda: SN.sense_normal(x, maps, w))
        plain_ms = cuda_ms(lambda: SN.sense_normal_plain(x, maps, w))
        library_ms = cuda_ms(
            lambda: _adjoint_impl(_forward_impl(x, maps6, m5), maps6, m5))
        launches = coil_launches(lambda: SN.sense_normal(x, maps, w))
        bound = _coil_bound(*SN.normal_work(E, C, w))
        results[B] = dict(
            max_abs_err=max_abs, rel_err=rel, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, device_ms_by_launch=launches,
            blocks_per_sm=blocks, **bound)
        print(f"kernel sense_normal B={B} [{B},{E},{T},{Y},{X}] C={C}: "
              f"max|k-p|/max|p| {rel:.3e} (max abs {max_abs:.3e}; cuFFT chain "
              f"{lib_rel:.3e}) kernel_ms {ms:.4f} (profiler device: "
              + ", ".join(f"{n} {t:.4f}" for n, t in launches.items())
              + f") plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
              + _bound_text(bound, ms))
    return results


def _bound_text(bound, ms):
    return (f"bound_ms {bound['bound_ms']:.4f} by {bound['bound_by']} at "
            f"3xTF32 DFTs ({bound['ops_ms']:.4f} by operations, "
            f"{bound['bytes_ms']:.4f} by bytes; {bound['gflop']:.3f} GFLOP, "
            f"{bound['mbytes']:.2f} MB; fp32 FMA {bound['fma_bound_ms']:.4f}) "
            f"achieved {bound['gflop'] / ms:.2f} TFLOP/s, "
            f"{bound['bound_ms'] / ms:.1%} of the bound")


def _attention_work(W, H, N, D, nW):
    """(FLOP, bytes) of one window-attention call: the two products, and
    q, k, v, out, bias and the mask each moved once."""
    flops = 4 * W * H * N * N * D
    nbytes = 4 * (4 * W * H * N * D + H * N * N + (nW * N * N if nW else 0))
    return flops, nbytes


def kernels_window_attention():
    """window_attention kernel vs plain vs SDPA at the full-width Swin
    block's shapes, batch 1 and 4, with and without the shift mask."""
    N = SWIN_WINDOW[0] * SWIN_WINDOW[1] * SWIN_WINDOW[2]
    H, D = SWIN_HEADS, SWIN_HEAD_DIM
    blocks = WA.blocks_per_sm(D)
    print(f"kernel window_attention: window_attn_fwd_kernel blocks per SM at "
          f"head_dim {D}: {blocks}")
    mask = torch.from_numpy(compute_shift_mask(
        *SWIN_GRID, SWIN_WINDOW, SWIN_SHIFT)).cuda()
    nW = mask.shape[0]
    rng = np.random.RandomState(SEED + 1)
    results = {}
    for B in (1, 4):
        W = nW * B
        q, k, v = (torch.from_numpy(rng.standard_normal((W, H, N, D)).astype(
            np.float32)).cuda() for _ in range(3))
        # a bias well above the init's +-0.04, so that it shapes the softmax
        bias = torch.from_numpy(
            0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).cuda()
        for masked in (True, False):
            m = mask if masked else None
            out = WA.window_attention(q, k, v, bias, m)
            plain = WA.window_attention_plain(q, k, v, bias, m)
            full = bias[None] + (mask.repeat(B, 1, 1)[:, None] if masked else 0)
            full = full.expand(W, H, N, N).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library = sdpa(q, k, v, attn_mask=full)
            torch.cuda.synchronize()
            scale = plain.abs().max().item()
            max_abs = (out - plain).abs().max().item()
            rel = max_abs / scale
            lib_rel = (library - plain).abs().max().item() / scale
            check(torch.isfinite(out).all().item(),
                  f"window_attention output not finite at B={B}")
            check(rel <= KERNEL_REL_TOL,
                  f"window_attention vs plain rel err {rel:.3e} > "
                  f"{KERNEL_REL_TOL} at B={B} mask={masked}")

            ms = cuda_ms(lambda: WA.window_attention(q, k, v, bias, m))
            plain_ms = cuda_ms(
                lambda: WA.window_attention_plain(q, k, v, bias, m))
            library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=full))
            device_ms = sum(device_ms_by_kernel(
                lambda: WA.window_attention(q, k, v, bias, m)).values())
            flops, nbytes = _attention_work(W, H, N, D, nW if masked else 0)
            t_ops = flops / (TF32_FLOPS / 3) * 1e3     # 3xTF32
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            fma_bound = max(flops / FP32_FLOPS * 1e3, t_bytes)
            results[B, masked] = dict(
                max_abs_err=max_abs, rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                fma_bound_ms=fma_bound, bound_share=bound / ms,
                device_ms=device_ms, blocks_per_sm=blocks,
                gflop=flops / 1e9, mbytes=nbytes / 1e6)
            print(f"kernel window_attention B={B} [{W},{H},{N},{D}] "
                  f"mask={'shift' if masked else 'none'}: max|k-p|/max|p| "
                  f"{rel:.3e} (max abs {max_abs:.3e}; SDPA {lib_rel:.3e}) "
                  f"kernel_ms {ms:.4f} (profiler device {device_ms:.4f}) "
                  f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                  f"bound_ms {bound:.4f} at 3xTF32 ({t_ops:.4f} by "
                  f"operations, {t_bytes:.4f} by bytes; {flops / 1e9:.3f} "
                  f"GFLOP, {nbytes / 1e6:.2f} MB; fp32 FMA {fma_bound:.4f}) "
                  f"achieved {flops / ms / 1e9:.2f} TFLOP/s, "
                  f"{bound / ms:.1%} of the 3xTF32 bound")
    return results


def _attention_bwd_work(W, H, N, D, nW):
    """(FLOP, bytes) of one window-attention backward: the five products
    (s, dp, dv, dq, dk); q, k, v, g in, dq, dk, dv out, bias in, dbias out
    and the mask in, each moved once."""
    flops = 10 * W * H * N * N * D
    nbytes = 4 * (7 * W * H * N * D + 2 * H * N * N
                  + (nW * N * N if nW else 0))
    return flops, nbytes


def device_ms_by_kernel(fn, runs=10):
    """{kernel name: device ms per fn() call}, from torch.profiler over runs
    back-to-back calls (L2 warm), after one call outside the profile."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / runs
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def _short(name):
    """A kernel's profiler name without its namespace, template and
    arguments."""
    found = re.search(r"attn_bwd_\w+|(?:coil|llr)_\w+_kernel|"
                      r"at::native::\w+", name)
    return found.group(0) if found else name


def _sdpa_backend(names):
    """The SDPA backend that ran the kernels of these profiler names."""
    for backend, keys in (("flash", ("flash",)),
                          ("efficient", ("fmha", "efficient", "mem_eff")),
                          ("cudnn", ("cudnn_sdpa", "sdpa_cudnn"))):
        if any(k in n.lower() for n in names for k in keys):
            return backend
    return "math"


def sdpa_backward(q, k, v, bias, mask, g):
    """SDPA's backward at the window-attention backward's inputs: a function
    of no arguments giving the gradients of q, k, v and of the float mask
    bias (+ mask of window w mod nW), which requires grad."""
    W, H, N, _ = q.shape
    full = bias[None] + (mask.repeat(W // mask.shape[0], 1, 1)[:, None]
                         if mask is not None else 0)
    full = full.expand(W, H, N, N).contiguous().requires_grad_(True)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           attn_mask=full)
    return lambda: torch.autograd.grad(out, (*leaves, full), g,
                                       retain_graph=True)


def kernels_window_attention_bwd():
    """window_attention_bwd kernel vs its plain version vs SDPA's backward
    (with the float mask bias + mask requiring grad) at the full-width Swin
    block's shapes, batch 1 and 4, with and without the shift mask; two
    calls must give bitwise-equal gradients."""
    N = SWIN_WINDOW[0] * SWIN_WINDOW[1] * SWIN_WINDOW[2]
    H, D = SWIN_HEADS, SWIN_HEAD_DIM
    mask = torch.from_numpy(compute_shift_mask(
        *SWIN_GRID, SWIN_WINDOW, SWIN_SHIFT)).cuda()
    nW = mask.shape[0]
    rng = np.random.RandomState(SEED + 2)
    results = {}
    for B in (1, 4):
        W = nW * B
        q, k, v, g = (torch.from_numpy(rng.standard_normal((W, H, N, D)).astype(
            np.float32)).cuda() for _ in range(4))
        bias = torch.from_numpy(
            0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).cuda()
        for masked in (True, False):
            m = mask if masked else None
            out, lse = WA.window_attention_fwd(q, k, v, bias, m)

            def kernel():
                return WA.window_attention_bwd(q, k, v, bias, m, g, out, lse)

            grads = kernel()
            again = kernel()
            plain = WA.window_attention_bwd_plain(q, k, v, bias, m, g)
            torch.cuda.synchronize()
            rels, max_abs = {}, 0.0
            for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), grads,
                                     plain, again):
                check(torch.isfinite(a).all().item(),
                      f"backward {name} not finite at B={B} mask={masked}")
                check(torch.equal(a, c), f"backward {name} differs between "
                      f"two calls at B={B} mask={masked}")
                err = (a - b).abs().max().item()
                rels[name] = err / b.abs().max().item()
                max_abs = max(max_abs, err)
                check(rels[name] <= KERNEL_REL_TOL,
                      f"backward {name} vs plain rel err {rels[name]:.3e} > "
                      f"{KERNEL_REL_TOL} at B={B} mask={masked}")

            library = sdpa_backward(q, k, v, bias, m, g)
            lib_kernels = device_ms_by_kernel(library)
            backend = _sdpa_backend(lib_kernels)
            lib_dq = library()[0]
            lib_rel = ((lib_dq - plain[0]).abs().max()
                       / plain[0].abs().max()).item()
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(
                lambda: WA.window_attention_bwd_plain(q, k, v, bias, m, g))
            library_ms = cuda_ms(library)
            launches = {_short(n): t for n, t in
                        device_ms_by_kernel(kernel).items()}
            lib_device_ms = sum(lib_kernels.values())
            del library
            flops, nbytes = _attention_bwd_work(W, H, N, D,
                                                nW if masked else 0)
            t_ops = flops / (TF32_FLOPS / 3) * 1e3     # 3xTF32
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            device_ms = sum(launches.values())
            results[B, masked] = dict(
                max_abs_err=max_abs, rel_err=max(rels.values()),
                rel_err_by_grad=rels, bitwise_equal_calls=True, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_backend=backend, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                fma_bound_ms=flops / FP32_FLOPS * 1e3, bound_share=bound / ms,
                device_ms=device_ms, device_ms_by_launch=launches,
                library_device_ms=lib_device_ms,
                gflop=flops / 1e9, mbytes=nbytes / 1e6)
            print(f"kernel window_attention_bwd B={B} [{W},{H},{N},{D}] "
                  f"mask={'shift' if masked else 'none'}: max|k-p|/max|p| "
                  + " ".join(f"{n} {r:.3e}" for n, r in rels.items())
                  + f" (max abs {max_abs:.3e}; two calls bitwise equal; SDPA "
                  f"dq {lib_rel:.3e}) kernel_ms {ms:.4f} (profiler device "
                  f"{device_ms:.4f}: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in launches.items())
                  + f") plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                  f"(SDPA backward, {backend} backend; profiler device "
                  f"{lib_device_ms:.4f}) bound_ms {bound:.4f} at 3xTF32 "
                  f"({t_ops:.4f} by operations, {t_bytes:.4f} by bytes; "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; fp32 FMA "
                  f"{flops / FP32_FLOPS * 1e3:.4f}) achieved "
                  f"{flops / ms / 1e9:.2f} TFLOP/s, {bound / ms:.1%} of the "
                  "3xTF32 bound")
    return results


def _llr_work(S, op, C, w2):
    """(DFT FLOP, other FLOP, bytes) of one block-LLR normal call as the
    kernel does it: the SENSE-normal passes of each system (DFTs over the R
    k-space rows of each frame that hold a nonzero weight; the weight, the
    coil expansion and sum), combine (a real weight times each block value,
    summed) and extract (a real weight times each value), Dinv once per
    pixel; the blocks in and out, maps, w2, Dinv and the complex64 DFT
    tables moved once."""
    T, Y, X = w2.shape
    E, b = op.ne, op.block_size
    rows = int((w2 != 0).any(dim=2).sum().item())   # R summed over frames
    yx = Y * X
    nel = S * op.num_blocks * E * b * b * T            # block values
    dft = S * C * rows * 8 * X * (2 * Y + 2 * X)
    other = (S * C * (rows * X * 2 + T * 8 * E * yx * 2)
             + 4 * nel + 2 * nel + 2 * S * E * T * yx)
    nbytes = (8 * nel * 2 + 8 * E * C * yx + 4 * T * yx + 4 * yx
              + 8 * (Y * Y + X * X))
    return dft, other, nbytes


def llr_inputs():
    """The block-LLR kernel's setting at the DSLR training point: (op, maps,
    w2, c64, plain, library); c64(*shape) draws seeded complex64 on the
    card, plain(blk, d_side) is the plain version and library(blk, d_side)
    the same function by PyTorch calls (BlockOp combine, the SENSE forward
    and adjoint on cuFFT, BlockOp extract)."""
    cfg = dslr_cfg()
    T, Y, X, C, E = headline_shape()
    p = cfg.MODEL.PARAMETERS
    op = BlockOp(p.DSLR.BLOCK_SIZE, (1, E, T, Y, X), device="cuda")
    u = cfg.AUG_TRAIN.UNDERSAMPLE
    mask = VDktMaskFunc(u.ACCELERATIONS, sim_partial_kx=u.PARTIAL_KX,
                        sim_partial_ky=u.PARTIAL_KY)((1, 1, T, Y, X), SEED)
    m5 = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).cuda()
    w2 = (m5[0, 0] * m5[0, 0]).contiguous()
    rng = np.random.RandomState(SEED + 3)

    def c64(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.complex64)).cuda()

    maps = c64(E, C, Y, X)
    maps6 = maps[None, :, :, None]
    py, px, dinv, _ = LN.geometry(op, "cuda")
    weights = op.weights + 1e-8

    def library(blk, d_side):
        """('post' undoes combine's division by the fold weights first)"""
        outs = []
        for b in blk:
            img = op(b, adjoint=True)
            if d_side == "post":
                img = img * weights
            img = _adjoint_impl(_forward_impl(img, maps6, m5), maps6, m5)
            outs.append(op(img if d_side == "pre" else img / weights))
        return torch.stack(outs)

    def plain(blk, d_side):
        return LN.mats_to_blocks(LN.llr_normal_plain(
            LN.blocks_to_mats(blk, op), maps, w2, py, px, dinv, d_side), op)

    return op, maps, w2, c64, plain, library


def kernels_llr_normal():
    """llr_normal kernel vs its plain version vs the operator chain on cuFFT
    at the DSLR training point's shapes: 'pre' and 'post', one system and
    two (the jacobi mode), the training mask; two calls must be bitwise
    equal."""
    op, maps, w2, c64, plain, library = llr_inputs()
    T, Y, X = w2.shape
    C = maps.shape[1]
    blocks = SN.blocks_per_sm(Y, X, LN._library())
    print(f"kernel llr_normal: coil_normal_kernel blocks per SM at {Y}x{X}: "
          f"{blocks}")
    check(blocks >= 2, f"llr coil pass fits {blocks} block(s) per SM")
    results = {}
    for S in (1, 2):
        blk = c64(S, op.num_blocks, op.ne * op.block_size ** 2, T)
        for d_side in ("pre", "post"):
            out = LN.llr_normal(blk, maps, w2, op, d_side)
            again = LN.llr_normal(blk, maps, w2, op, d_side)
            ref = plain(blk, d_side)
            lib = library(blk, d_side)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            max_abs = (out - ref).abs().max().item()
            rel = max_abs / scale
            lib_rel = (lib - ref).abs().max().item() / scale
            tag = f"{d_side} S={S}"
            check(torch.isfinite(torch.view_as_real(out)).all().item(),
                  f"llr_normal output not finite, {tag}")
            check(torch.equal(out, again),
                  f"llr_normal differs between two calls, {tag}")
            check(rel <= KERNEL_REL_TOL,
                  f"llr_normal vs plain rel err {rel:.3e} > {KERNEL_REL_TOL}, "
                  f"{tag}")
            check(lib_rel <= KERNEL_REL_TOL,
                  f"operator chain vs plain rel err {lib_rel:.3e}, {tag}")

            ms = cuda_ms(lambda: LN.llr_normal(blk, maps, w2, op, d_side))
            plain_ms = cuda_ms(lambda: plain(blk, d_side))
            library_ms = cuda_ms(lambda: library(blk, d_side))
            launches = coil_launches(
                lambda: LN.llr_normal(blk, maps, w2, op, d_side))
            bound = _coil_bound(*_llr_work(S, op, C, w2))
            results[d_side, S] = dict(
                max_abs_err=max_abs, rel_err=rel, bitwise_equal_calls=True,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms_by_launch=launches, blocks_per_sm=blocks, **bound)
            print(f"kernel llr_normal {tag} blocks {list(blk.shape)} C={C} "
                  f"{Y}x{X}: max|k-p|/max|p| {rel:.3e} (max abs {max_abs:.3e};"
                  f" two calls bitwise equal; operator chain {lib_rel:.3e}) "
                  f"kernel_ms {ms:.4f} (profiler device, coil pass: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in launches.items())
                  + f") plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                  + _bound_text(bound, ms))
    return results


def _time_recon(recon, examples, batch_size, repeats):
    """(outputs of the first run, median seconds per run) over all slices."""
    out, times = None, []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = [recon(b) for b in batched(examples, batch_size)]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out = np.concatenate(res) if out is None else out
    return out, float(np.median(times))


SENSE_GROUP = "SENSE coil passes (sense_normal; llr_normal's middle)"
# kernel-name fragments -> the layer they belong to, first match wins (the
# backward's kernels before the forward's); the conv group also takes the
# Swin trunk's linear layers (cuBLAS GEMMs) and, in training, their weight
# and data gradients
_GROUPS = (("window attention backward kernel", ("attn_bwd",)),
           ("window attention kernel", ("window_attn",)),
           ("layer norm", ("layer_norm",)),
           ("Adam update", ("adam", "multi_tensor")),
           ("LLR combine/extract (llr_normal kernel)",
            ("llr_combine", "llr_extract")),
           (SENSE_GROUP,
            ("coil_normal", "coil_combine")),
           ("FFTs (cuFFT's A^H y, cuDNN's FFT convs)", ("fft",)),
           ("copies host<->device", ("memcpy",)),
           ("conv trunk (cuDNN)", ("conv", "xmma", "gemm", "cudnn", "implicit",
                                   "wgrad", "dgrad")))


def _range_kernels(prof, name):
    """The device kernels launched by the ops inside the record_function
    ranges called `name`, and by their autograd backward (linked by the
    forward ops' sequence numbers): [(kernel name, device ms)]."""
    events = prof.events()
    seqs, picked = set(), []
    for e in events:
        if e.name == name:
            stack = [e]
            while stack:
                c = stack.pop()
                stack.extend(c.cpu_children)
                picked.append(c)
                if c.sequence_nr >= 0:
                    seqs.add(c.sequence_nr)
    for e in events:
        if (e.name.startswith("autograd::engine::evaluate_function")
                and e.sequence_nr in seqs):
            stack = [e]
            while stack:
                c = stack.pop()
                stack.extend(c.cpu_children)
                picked.append(c)
    return [(k.name, k.duration / 1e3) for e in picked for k in e.kernels]


def _group(name):
    name = name.lower()
    return next((g for g, keys in _GROUPS if any(k in name for k in keys)),
                "other (elementwise)")


def profile_device(label, fn, split=None):
    """Device time of fn() by kernel group, from torch.profiler, against the
    host-clock time of the profiled run; returns ({group: ms}, busy ms).
    With `split`, the kernels of the record_function ranges of that name
    (and of their backward) form a group of their own."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += e.self_device_time_total / 1e3
    busy_ms = sum(groups.values())
    if busy_ms == 0.0:
        print("profile: the profiler saw no device time; breakdown not measured")
        return {}, 0.0
    if split is not None:
        own = _range_kernels(prof, split)
        for name, ms in own:
            groups[_group(name)] -= ms
        groups[split] = sum(ms for _, ms in own)
        if not own:
            print(f"profile: no kernel was attributed to {split}; its group "
                  "not measured")
    parts = ", ".join(f"{g} {ms:.3f}" for g, ms in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"profile: {label}, profiled: host {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}); ms by "
          f"group: {parts}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    return dict(groups), busy_ms


def run_path(tag, cfg, expected, cpu_tol=CPU_REL_L2_TOL, cpu_unrolls=None,
             batch_invariant=True):
    """Drive one reconstruction path through Reconstructor on the card and
    check it. `expected` maps each counter of COUNTERS to its launches per
    batch; returns ({counter: {batch size: launches}}, the raw slices, their
    examples, the batch-1 outputs, the weights, one slice's device ms by
    kernel group). The CPU comparison runs the config's unrolls, or
    `cpu_unrolls` of them (the same config cut, on both devices). A path
    whose output depends on the batch (`batch_invariant` False: the hqs
    rule's CG takes its step sizes from inner products over the whole
    batch, in the JAX package too) prints batch 1 against batch 4 instead
    of holding them to 1e-4."""
    cfg.freeze()
    T, Y, X, C, E = headline_shape()
    nunroll = cfg.MODEL.PARAMETERS.NUM_UNROLLS

    t0 = time.perf_counter()
    slices = [make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=SEED + s)
              for s in range(SLICES)]
    transform = ResampleTransform(ACCEL, cfg)
    examples = [transform(k, m) for k, m, _ in slices]
    host_s = time.perf_counter() - t0
    print(f"{tag}: {SLICES} slices [{C},{T},{Y},{X}] E={E} at {ACCEL}x "
          f"(seed {PARITY_SEED}); host data + transforms {host_s:.2f} s")

    params = init_params(cfg, SEED)
    recon = Reconstructor(cfg, params)          # the GPU: no device given
    check(recon.device.type == "cuda", f"Reconstructor on {recon.device}")
    recon(next(batched(examples[:1], 1)))       # warm-up (cuDNN, allocator)
    torch.cuda.reset_peak_memory_stats()

    counts = {name: {} for name in COUNTERS}
    outs = {}
    for bs in (1, 4):
        zero_counts()
        out, _ = _time_recon(recon, examples, bs, repeats=1)
        nbatch = -(-SLICES // bs)
        for name, n in read_counts().items():
            counts[name][bs] = n
            check(n == expected.get(name, 0) * nbatch,
                  f"{tag} batch {bs}: {n} {name} launches, expected "
                  f"{expected.get(name, 0)} per batch x {nbatch} batches")
        outs[bs] = out
        check(out.shape == (SLICES, E, T, Y, X), f"output shape {out.shape}")
        check(np.isfinite(out).all(), f"non-finite output at batch {bs}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rel_b = np.linalg.norm(outs[1] - outs[4]) / np.linalg.norm(outs[1])
    if batch_invariant:
        check(rel_b <= 1e-4, f"batch 1 vs batch 4 outputs differ: {rel_b:.3e}")

    for bs in (1, 4):
        _, sec = _time_recon(recon, examples, bs, repeats=3)
        launches = ", ".join(f"{counts[n][bs]} {n}" for n in expected
                             if expected[n])
        print(f"{tag} batch {bs}: {sec / SLICES * 1e3:.2f} ms per slice, "
              f"{SLICES * T / sec:.1f} frames/s, launches {launches} ("
              + ", ".join(f"{expected[n]} {n}" for n in expected
                          if expected[n]) + " per batch)")
    print(f"{tag}: peak device memory {peak_gb:.2f} GB; batch 1 vs 4 rel L2 "
          f"{rel_b:.2e}")

    # where one slice's time goes: the trunk of one unroll alone, then the
    # device time of one slice by kernel group
    x0 = torch.from_numpy(examples[0]["init_image"][None]).cuda()
    with torch.inference_mode():
        trunk_ms = cuda_ms(lambda: recon.model.nets[0](x0), runs=10)
    print(f"{tag}: denoiser trunk {trunk_ms:.3f} ms per unroll per slice "
          f"(x{nunroll} unrolls)")
    batch = next(batched(examples[:1], 1))
    groups = profile_device(f"{tag}: one slice, batch 1",
                            lambda: recon(batch))
    if groups[1] > 0:
        sense_ms = groups[0].get(SENSE_GROUP, 0.0)
        print(f"{tag}: SENSE normal kernel {sense_ms:.3f} ms of one slice's "
              f"{groups[1]:.3f} ms device time ({sense_ms / groups[1]:.2%}), "
              f"{expected.get('sense_normal', 0)} launches")

    gpu_out, cut_cfg, cut_params = outs[1][:1], cfg, params
    if cpu_unrolls is not None:
        cut_cfg = _cut(cfg, cpu_unrolls)
        cut_params = init_params(cut_cfg, SEED)
        gpu_out = Reconstructor(cut_cfg, cut_params)(batch)
    t0 = time.perf_counter()
    cpu = Reconstructor(cut_cfg, cut_params, device="cpu")(batch)
    cpu_s = time.perf_counter() - t0
    rel_cpu = np.linalg.norm(gpu_out - cpu) / np.linalg.norm(cpu)
    print(f"{tag}: slice 0 vs the port's CPU path "
          f"({cut_cfg.MODEL.PARAMETERS.NUM_UNROLLS} unrolls, "
          f"{cpu_s:.1f} s on the CPU): rel L2 {rel_cpu:.3e}")
    check(rel_cpu <= cpu_tol, f"GPU vs CPU rel L2 {rel_cpu:.3e} > {cpu_tol}")
    return counts, slices, examples, outs[1], params, groups


def phase_main():
    """The headline RES path: no window attention."""
    cfg = headline_cfg()
    nunroll = cfg.MODEL.PARAMETERS.NUM_UNROLLS
    return run_path("main", cfg, {"sense_normal": nunroll,
                                  "window_attention": 0,
                                  "window_attention_bwd": 0})[0]


def phase_swin():
    """The unrolled-Swin path: one window-attention call per Swin block."""
    cfg = swin_cfg()
    p = cfg.MODEL.PARAMETERS
    blocks = 6 * p.NUM_SWINBLOCKS               # depths (6,) per trunk
    return run_path("swin", cfg, {
        "sense_normal": p.NUM_UNROLLS,
        "window_attention": blocks * p.NUM_UNROLLS,
        "window_attention_bwd": 0})[0]


class _InMemory:
    """Raw slices held in memory, preprocessed on access: the dataset the
    DataLoader reads in place of an Hdf5Dataset (no h5py needed)."""

    def __init__(self, slices, transform):
        self.slices, self.transform = slices, transform

    def __len__(self):
        return len(self.slices)

    def __getitem__(self, i):
        k, m, t = self.slices[i]
        return self.transform(k, m, t, f"chip_smoke_{i}")


def _train_launches(cfg):
    """Kernel launches of one train step of the unrolled Swin solver, from
    the code: each Swin block calls window attention once in the forward,
    once more in remat's recompute, and its backward once; each unroll calls
    the SENSE normal op once, and its backward (self-adjoint: the same
    kernel) runs for every unroll but the first, whose input needs no
    gradient."""
    p = cfg.MODEL.PARAMETERS
    blocks = 6 * p.NUM_SWINBLOCKS * p.NUM_UNROLLS   # depths (6,) per trunk
    return {"window_attention": blocks * (2 if p.GRAD_CHECKPOINT else 1),
            "window_attention_bwd": blocks,
            "sense_normal": 2 * p.NUM_UNROLLS - 1}


def _step_and_grads(cfg, params, batch, device, trainer_cls=Trainer):
    """(loss, flat gradient, seconds) of one train step from `params`."""
    trainer = trainer_cls(cfg, device=device)
    state = trainer.init_state(state_dict=params)
    t0 = time.perf_counter()
    loss = float(trainer.train_step(state, batch)["Train/complex_l1"])
    seconds = time.perf_counter() - t0
    grads = torch.cat([p.grad.flatten().cpu() for p in
                       state.model.parameters() if p.grad is not None])
    return loss, grads, seconds


def phase_train():
    """config_swin.yaml's training path through Trainer on the card."""
    cfg = swin_cfg(output_dir=str(RUNS))
    T, Y, X, C, E = headline_shape()
    trainer = Trainer(cfg)                      # the GPU: no device given
    check(trainer.device.type == "cuda", f"Trainer on {trainer.device}")
    batches = _train_batches("train", cfg, trainer, TRAIN_STEPS + 1)
    state = trainer.init_state(state_dict=init_params(cfg, SEED))
    counts = _timed_steps("train", trainer, state, batches,
                          _train_launches(cfg), ("Train/complex_l1",))[0]

    metrics, pred = trainer.val_step(state, batches[0])
    check(pred.shape == (1, E, T, Y, X) and torch.isfinite(
        torch.view_as_real(pred)).all().item(), f"val_step output {pred.shape}")
    print("train: val_step " + ", ".join(
        f"{k} {float(v):.6f}" for k, v in metrics.items()))

    # a checkpoint of this state, reloaded into the serving path
    shutil.rmtree(RUNS, ignore_errors=True)
    CheckpointManager(str(RUNS / "checkpoints")).save(state.step, state)
    recon = Reconstructor(cfg, load_checkpoint_params(str(RUNS / "checkpoints")))
    out = recon(batches[0])
    ref = (pred * torch.from_numpy(batches[0]["scale"]).cuda().reshape(
        -1, 1, 1, 1, 1)).cpu().numpy()
    rel_ck = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    print(f"train: checkpoint at step {state.step} through "
          f"load_checkpoint_params and Reconstructor vs val_step: rel L2 "
          f"{rel_ck:.3e}")
    check(rel_ck <= 1e-6, f"checkpoint reconstruction rel L2 {rel_ck:.3e}")

    # one step against the port's CPU path, cut to 1 unroll at full width:
    # the same weights, batch and dropout seed (stochastic depth on)
    cut = _cut(cfg, 1)
    _cpu_step_check("train", cut, init_params(cut, SEED), batches[0])
    shutil.rmtree(RUNS, ignore_errors=True)
    return counts


def _dslr_launches(cfg):
    """Block-LLR normal launches of one DSLR train step, from the code: each
    unroll runs two factor solves (L, then R), each of which applies the
    operator once for its initial residual and once per CG step. The solves
    of the first unroll start from the loader's L0 and R0 and see no
    parameter, so none of their inputs needs a gradient; every later
    application runs its adjoint ('post') once in the backward."""
    p = cfg.MODEL.PARAMETERS
    per_unroll = 2 * (1 + p.DSLR.NUM_CG_STEPS)
    return {"llr_normal_pre": p.NUM_UNROLLS * per_unroll,
            "llr_normal_post": (p.NUM_UNROLLS - 1) * per_unroll}


def _dslr_compare_cpu(batch):
    """One train step and one val_step at DSLR_CUT_UNROLLS unrolls, full
    width, on the card and on the port's CPU path: the same weights and
    batch."""
    cut = dslr_cfg(output_dir=str(RUNS))
    cut.MODEL.PARAMETERS.NUM_UNROLLS = DSLR_CUT_UNROLLS
    params = init_params(cut, SEED)
    _cpu_step_check("dslr", cut, params, batch, DSLRTrainer)

    preds = {}
    for device in ("cuda", "cpu"):
        trainer = DSLRTrainer(cut, device=device)
        state = trainer.init_state(state_dict=params)
        preds[device] = trainer.val_step(state, batch)[1].cpu().numpy()
    rel_val = (np.linalg.norm(preds["cuda"] - preds["cpu"])
               / np.linalg.norm(preds["cpu"]))
    print(f"dslr: val_step at {DSLR_CUT_UNROLLS} unrolls vs the port's CPU "
          f"path: rel L2 {rel_val:.3e}")
    check(rel_val <= CPU_REL_L2_TOL, f"dslr val_step GPU vs CPU rel L2 "
          f"{rel_val:.3e} > {CPU_REL_L2_TOL}")


def _dslr_jacobi(batch):
    """One val_step of the dslr-cg-jacobi mode: both factor systems in one
    launch (S=2) for each operator application."""
    cfg = dslr_cfg(output_dir=str(RUNS))
    p = cfg.MODEL.PARAMETERS
    cfg.MODEL.META_ARCHITECTURE = "dslr-cg-jacobi"
    p.DSLR.NUM_CG_STEPS = JACOBI_CG_STEPS
    trainer = DSLRTrainer(cfg)
    state = trainer.init_state(state_dict=init_params(cfg, SEED))
    trainer.val_step(state, batch)                  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    metrics, pred = trainer.val_step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    expected = p.NUM_UNROLLS * (1 + p.DSLR.NUM_CG_STEPS)
    systems = LN.llr_normal.systems["pre"]
    check(counts["llr_normal_pre"] == expected and systems == 2 * expected
          and sum(counts.values()) == expected,
          f"jacobi val_step: launches {counts}, {systems} systems, expected "
          f"{expected} launches of 2 systems")
    check(torch.isfinite(torch.view_as_real(pred)).all().item(),
          "jacobi val_step output not finite")
    print(f"dslr: jacobi ({JACOBI_CG_STEPS} CG steps) val_step {ms:.2f} ms, "
          f"{expected} llr_normal launches of 2 systems; "
          + ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items()))
    return counts


def phase_dslr():
    """config_dslr.yaml's training path through DSLRTrainer on the card."""
    cfg = dslr_cfg(output_dir=str(RUNS))
    p = cfg.MODEL.PARAMETERS
    T, Y, X, C, E = headline_shape()
    trainer = DSLRTrainer(cfg)                  # the GPU: no device given
    check(trainer.device.type == "cuda", f"DSLRTrainer on {trainer.device}")
    batches = _train_batches("dslr", cfg, trainer, TRAIN_STEPS + 1)
    op = BlockOp(p.DSLR.BLOCK_SIZE, (1, E, T, Y, X), xp=np)
    r = p.DSLR.NUM_BASIS
    check(batches[0]["L_init"].shape == (1, op.num_blocks,
                                         E * p.DSLR.BLOCK_SIZE ** 2, r)
          and batches[0]["R_init"].shape == (1, op.num_blocks, T, r),
          f"L_init {batches[0]['L_init'].shape}, R_init "
          f"{batches[0]['R_init'].shape}")
    print(f"dslr: {op.num_blocks} blocks of {p.DSLR.BLOCK_SIZE}x"
          f"{p.DSLR.BLOCK_SIZE}, L {list(batches[0]['L_init'].shape[1:])}, "
          f"R {list(batches[0]['R_init'].shape[1:])}")

    state = trainer.init_state(state_dict=init_params(cfg, SEED))
    expected = _dslr_launches(cfg)
    counts = _timed_steps("dslr", trainer, state, batches, expected,
                          ("Train/complex_l1",))[0]
    counts = {name: {"train steps": c["steps"]} for name, c in counts.items()}

    val_times = []
    for _ in range(3):
        zero_counts()
        t0 = time.perf_counter()
        metrics, pred = trainer.val_step(state, batches[0])
        torch.cuda.synchronize()
        val_times.append(time.perf_counter() - t0)
    val = read_counts()
    for name, n in val.items():
        counts[name]["val_step"] = n
    check(val["llr_normal_pre"] == expected["llr_normal_pre"]
          and sum(val.values()) == val["llr_normal_pre"],
          f"dslr val_step launches {val}")
    check(pred.shape == (1, E, T, Y, X) and torch.isfinite(
        torch.view_as_real(pred)).all().item(), f"val_step output {pred.shape}")
    print(f"dslr: val_step {np.median(val_times) * 1e3:.2f} ms per slice "
          f"(median of 3), {val['llr_normal_pre']} llr_normal launches; "
          + ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items()))
    profile_device("dslr: one val_step",
                   lambda: trainer.val_step(state, batches[0]))

    _dslr_compare_cpu(batches[0])
    for name, n in _dslr_jacobi(batches[0]).items():
        counts[name]["jacobi val_step"] = n
    shutil.rmtree(RUNS, ignore_errors=True)
    return counts


def headline_train(counts):
    """The bench's train step at HEADLINE_POINTS: times, launches, memory,
    and one step's device time by kernel group."""
    for B, remat, dtype in HEADLINE_POINTS:
        label = f"B={B} {dtype}" + (" remat" if remat else "")
        step = bench.TrainStep(B, remat, dtype, "cuda")
        check(step.trainer.device.type == "cuda",
              f"headline Trainer on {step.trainer.device}")
        step()                                  # warm-up (cuDNN, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times, losses = [], []
        for _ in range(HEADLINE_STEPS):
            t0 = time.perf_counter()
            metrics = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["Train/complex_l1"]))
        expected = step.sense_launches * HEADLINE_STEPS
        for name, n in read_counts().items():
            counts[name][f"train {label}"] = n
            want = expected if name == "sense_normal" else 0
            check(n == want, f"headline {label}: {n} {name} launches in "
                  f"{HEADLINE_STEPS} steps, expected {want}")
        check(np.isfinite(losses).all(), f"headline {label} losses {losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = float(np.median(times)) * 1e3
        print(f"headline: train step {label}: {ms:.2f} ms per step (median "
              f"of {HEADLINE_STEPS}; {', '.join(f'{t * 1e3:.2f}' for t in times)}"
              f"), {B / ms * 1e3:.3f} samples/s, peak device memory "
              f"{peak_gb:.2f} GB; complex_l1 per step "
              f"{', '.join(f'{x:.6f}' for x in losses)}; "
              f"{step.sense_launches} sense_normal launches per step")
        profile_device(f"headline: one train step {label}", step)
        del step, metrics
        torch.cuda.empty_cache()


def headline_bf16_vs_cpu():
    """One bfloat16 train step at 1 unroll, full width, on the card and on
    the port's CPU path: the same weights and batch."""
    cfg = bench.bench_cfg("bfloat16")
    cfg.defrost()
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = 1
    cfg.freeze()
    batch = bench.device_batch(cfg, 1, torch.device("cpu"))
    params = init_params(cfg, SEED)
    gpu = _step_and_grads(cfg, params, batch, "cuda")
    cpu = _step_and_grads(cfg, params, batch, "cpu")
    rel_loss = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    rel_grad = ((gpu[1] - cpu[1]).norm() / cpu[1].norm()).item()
    print(f"headline: one bfloat16 step at 1 unroll vs the port's CPU "
          f"bfloat16 step ({cpu[2]:.1f} s on the CPU): loss {gpu[0]:.6f} vs "
          f"{cpu[0]:.6f} (rel {rel_loss:.3e}), gradient rel L2 "
          f"{rel_grad:.3e} over {cpu[1].numel()} values")
    check(rel_loss <= BF16_LOSS_REL_TOL,
          f"bf16 GPU vs CPU train loss rel {rel_loss:.3e} > {BF16_LOSS_REL_TOL}")
    check(rel_grad <= BF16_GRAD_REL_L2_TOL,
          f"bf16 GPU vs CPU gradient rel L2 {rel_grad:.3e} > "
          f"{BF16_GRAD_REL_L2_TOL}")


def _scanner_cfl(directory, slices, examples):
    """Write the slices' 12x k-space and their maps as scanner CFLs (BART
    dims: k-space [x, y, slice, coil, 1, echo, 1, phase], maps [x, y, slice,
    coil, emap]; the scanner's data is not fftmod'ed), one echo; returns
    their paths and the arrays as reconstruct_cfl reads them per slice."""
    ks = np.stack([fftmod(k * ex["mask"]) for (k, _, _), ex in
                   zip(slices, examples)]).astype(np.complex64)
    maps = np.stack([fftmod(m[:, :, 0]) for _, m, _ in slices]
                    ).astype(np.complex64)            # [S, E, C, Y, X]
    file_ks, file_maps = str(directory / "ks"), str(directory / "maps")
    cfl.write(file_ks, np.transpose(ks, (4, 3, 0, 1, 2))[
        :, :, :, :, None, None, None, :], order="F")
    cfl.write(file_maps, np.transpose(maps, (4, 3, 0, 2, 1)), order="F")
    return file_ks, file_maps, ks, maps[:, :, :, None]


def headline_serve(counts):
    """main's slices served with the bfloat16 trunk, scored against their
    1x adjoint, and the same weights through the CFL deployment path."""
    cfg = headline_cfg()
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "bfloat16"
    nunroll = cfg.MODEL.PARAMETERS.NUM_UNROLLS
    serve_counts, slices, examples, out, params, _ = run_path(
        "headline bf16 serving", cfg, {"sense_normal": nunroll,
                                       "window_attention": 0,
                                       "window_attention_bwd": 0},
        cpu_tol=BF16_REL_L2_TOL)
    for name, by_bs in serve_counts.items():
        for bs, n in by_bs.items():
            counts[name][f"serve bf16 batch {bs}"] = n

    # the evaluator: SSIM and PSNR against the fully-sampled adjoint
    reference = accel_transform(cfg, 1)
    ref = reconstruct_examples([reference(k, m) for k, m, _ in slices], None)
    scores = {"bf16 trunk (seeded weights)": evaluate_volumes(ref, out),
              "zero-filled": evaluate_volumes(
                  ref, reconstruct_examples(examples, None))}
    for label, per in scores.items():
        ssim, psnr = float(per["ssim"].mean()), float(per["psnr"].mean())
        check(np.isfinite(ssim) and np.isfinite(psnr) and -1 <= ssim <= 1,
              f"evaluator on {label}: ssim {ssim}, psnr {psnr}")
        print(f"headline: {SLICES} slices at {ACCEL}x, {label}, against the "
              f"1x adjoint: SSIM {ssim:.6f} PSNR {psnr:.4f} dB (mean over "
              f"{per['ssim'].size} frames)")

    # the CFL deployment path vs Reconstructor on the same scanner arrays
    directory = RUNS / "cfl"
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    file_ks, file_maps, ks, maps = _scanner_cfl(directory, slices, examples)
    zero_counts()
    t0 = time.perf_counter()
    reconstruct_cfl(file_ks, file_maps, str(directory / "im"), cfg, params)
    cfl_s = time.perf_counter() - t0
    got = read_counts()
    check(got["sense_normal"] == nunroll * SLICES,
          f"reconstruct_cfl: {got['sense_normal']} sense_normal launches")
    counts["sense_normal"]["reconstruct_cfl"] = got["sense_normal"]
    im = cfl.read(str(directory / "im"), order="F")
    T, Y, X, C, E = headline_shape()
    check(im.shape == (X, Y, SLICES, 1, E, 1, 1, T),
          f"reconstruct_cfl output dims {im.shape}")
    im = np.transpose(im[:, :, :, 0, :, 0, 0, :], (2, 3, 4, 1, 0))
    transform = InferenceTransform(cfg, apply_fftmod=True)
    want = reconstruct_examples([transform(k, m) for k, m in zip(ks, maps)],
                                Reconstructor(cfg, params))   # batch 1
    rel = np.linalg.norm(im - want) / np.linalg.norm(want)
    print(f"headline: reconstruct_cfl of {SLICES} slices (CFL k-space "
          f"{list(ks.shape)}, one echo) in {cfl_s:.2f} s, output dims "
          f"[x, y, slice, 1, emap, echo, 1, phase]; vs Reconstructor on the "
          f"same scanner arrays: rel L2 {rel:.3e}")
    check(rel <= CFL_REL_L2_TOL, f"reconstruct_cfl vs Reconstructor rel L2 "
          f"{rel:.3e} > {CFL_REL_L2_TOL}")
    shutil.rmtree(directory, ignore_errors=True)


def phase_headline():
    """The RES main path on the card: the bench's train step, bfloat16
    against the CPU, bfloat16 serving scored by the evaluator, CFL."""
    counts = {name: {} for name in COUNTERS}
    headline_train(counts)
    headline_bf16_vs_cpu()
    headline_serve(counts)
    return counts


def _train_batches(tag, cfg, trainer, n):
    """n full-width slices (readout RAW_X, cropped by the config) through the
    trainer's preprocess and DataLoader in memory, at batch 1."""
    T, Y, X, C, E = headline_shape()
    t0 = time.perf_counter()
    slices = [make_cine_example(T=T, Y=Y, X=RAW_X, C=C, E=E, seed=SEED + s)
              for s in range(n)]
    loader = DataLoader(_InMemory(slices, trainer.make_preprocess(
        use_seed=True)), batch_size=cfg.DATALOADER.TRAIN_BATCH_SIZE,
        num_workers=1, shuffle=True, seed=cfg.SEED)
    trainer.set_steps_per_epoch(len(loader))
    batches = list(loader)
    crop = cfg.AUG_TRAIN.CROP_READOUT
    check(batches[0]["kspace"].shape == (1, C, T, Y, crop),
          f"{tag}: batch k-space {batches[0]['kspace'].shape}")
    print(f"{tag}: {n} slices [{C},{T},{Y},{RAW_X}] E={E} through "
          f"CinePreprocess (readout cropped to {crop}) and DataLoader; host "
          f"data {time.perf_counter() - t0:.2f} s")
    return batches


def _timed_steps(tag, trainer, state, batches, expected, keys,
                 split=None):
    """One warm-up step on batches[0], then one timed step on each later
    batch: the launches per step checked against `expected`, the metrics
    `keys` per step, ms per step, peak memory; then one profiled step.
    Returns ({counter: {"steps": launches}}, median ms, {key: [values]},
    the profile's (groups, busy ms))."""
    trainer.train_step(state, batches[0])       # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, values = [], {k: [] for k in keys}
    for b in batches[1:]:
        t0 = time.perf_counter()
        metrics = trainer.train_step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for k in keys:
            values[k].append(float(metrics[k]))
    steps = len(times)
    counts = {name: {"steps": n} for name, n in read_counts().items()}
    for name, n in read_counts().items():
        check(n == expected.get(name, 0) * steps,
              f"{tag}: {n} {name} launches in {steps} steps, expected "
              f"{expected.get(name, 0)} per step")
    for k, v in values.items():
        check(np.isfinite(v).all(), f"{tag}: {k} per step {v}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(times)) * 1e3
    print(f"{tag}: {ms:.2f} ms per train step (median of {steps}; "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), batch 1, peak "
          f"device memory {peak_gb:.2f} GB; "
          + "; ".join(f"{k.split('/')[-1]} per step "
                      + ", ".join(f"{x:.6f}" for x in v)
                      for k, v in values.items())
          + "; launches per step "
          + ", ".join(f"{counts[n]['steps'] // steps} {n}" for n in expected))
    groups = profile_device(f"{tag}: one train step",
                            lambda: trainer.train_step(state, batches[1]),
                            split=split)
    return counts, ms, values, groups


def _cpu_step_check(tag, cut, params, batch, trainer_cls=Trainer):
    """One train step of the cut config on the card and on the port's CPU
    path from the same weights and batch, held to the train limits."""
    gpu = _step_and_grads(cut, params, batch, "cuda", trainer_cls)
    cpu = _step_and_grads(cut, params, batch, "cpu", trainer_cls)
    rel_loss = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    rel_grad = ((gpu[1] - cpu[1]).norm() / cpu[1].norm()).item()
    T = batch["kspace"].shape[2]
    print(f"{tag}: one step at {cut.MODEL.PARAMETERS.NUM_UNROLLS} unroll(s), "
          f"{T} frames, vs the port's CPU path ({cpu[2]:.1f} s on the CPU): "
          f"loss {gpu[0]:.6f} vs {cpu[0]:.6f} (rel {rel_loss:.3e}), gradient "
          f"rel L2 {rel_grad:.3e} over {cpu[1].numel()} values")
    check(rel_loss <= TRAIN_LOSS_REL_TOL,
          f"{tag} GPU vs CPU train loss rel {rel_loss:.3e}")
    check(rel_grad <= TRAIN_GRAD_REL_L2_TOL,
          f"{tag} GPU vs CPU gradient rel L2 {rel_grad:.3e}")


def _cut(cfg, unrolls):
    """A frozen copy of cfg with `unrolls` unrolls."""
    cut = cfg.clone()
    cut.defrost()
    cut.MODEL.PARAMETERS.NUM_UNROLLS = unrolls
    cut.freeze()
    return cut


def _serving(nunroll, sense_per_unroll=1):
    return {"sense_normal": nunroll * sense_per_unroll,
            "window_attention": 0, "window_attention_bwd": 0}


def phase_se():
    """config_se.yaml (the SE trunk, 384 features, RR 16) served and trained
    through Reconstructor and Trainer; the CBAM trunk served at
    configs/quality/cbam.yaml's widths."""
    cfg = se_cfg(output_dir=str(RUNS))
    nunroll = cfg.MODEL.PARAMETERS.NUM_UNROLLS
    counts = {name: {} for name in COUNTERS}
    served = run_path("se", cfg, _serving(nunroll),
                      cpu_unrolls=SE_CPU_UNROLLS)[0]
    for name, by_bs in served.items():
        for bs, n in by_bs.items():
            counts[name][f"serve batch {bs}"] = n

    train_cfg = se_cfg(output_dir=str(RUNS))
    train_cfg.freeze()
    trainer = Trainer(train_cfg)                # the GPU: no device given
    check(trainer.device.type == "cuda", f"Trainer on {trainer.device}")
    batches = _train_batches("se train", train_cfg, trainer,
                             SE_TRAIN_STEPS + 1)
    state = trainer.init_state(state_dict=init_params(train_cfg, SEED))
    trained, _, _, _ = _timed_steps(
        "se train", trainer, state, batches,
        {"sense_normal": 2 * nunroll - 1}, ("Train/complex_l1",))
    for name, c in trained.items():
        counts[name]["train steps"] = c["steps"]
    del trainer, state
    torch.cuda.empty_cache()
    cut = _cut(train_cfg, SE_CPU_UNROLLS)
    _cpu_step_check("se train", cut, init_params(cut, SEED), batches[0])

    cbam = quality_cfg(model="cbam")
    cbam.OUTPUT_DIR = str(RUNS)
    served = run_path("cbam", cbam,
                      _serving(cbam.MODEL.PARAMETERS.NUM_UNROLLS))[0]
    for name, by_bs in served.items():
        for bs, n in by_bs.items():
            counts[name][f"cbam serve batch {bs}"] = n
    shutil.rmtree(RUNS, ignore_errors=True)
    return counts


def phase_modl():
    """The example config with the hqs (MoDL) rule: each unroll's CG solve
    applies the SENSE normal op once for its residual and once per CG
    step; the SENSE kernel's share of a slice's device time is printed."""
    cfg = headline_cfg()
    cfg.MODEL.META_ARCHITECTURE = "modl"
    p = cfg.MODEL.PARAMETERS
    per_unroll = 1 + p.MODL.NUM_CG_STEPS
    served = run_path("modl", cfg, _serving(p.NUM_UNROLLS, per_unroll),
                      batch_invariant=False)[0]
    return {name: {f"serve batch {bs}": n for bs, n in by_bs.items()}
            for name, by_bs in served.items()}


def _gan_step(cfg, g_params, batch, device):
    """(losses, generator gradient, discriminator gradient, seconds) of one
    GANTrainer step from the seeded weights, stochastic depth off."""
    trainer = GANTrainer(cfg, device=device)
    state = trainer.init_state(state_dict=g_params)
    for m in state.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    t0 = time.perf_counter()
    metrics = trainer.train_step(state, batch)
    seconds = time.perf_counter() - t0
    losses = {k: float(metrics[k]) for k in GAN_KEYS}

    def flat(module):
        return torch.cat([p.grad.flatten().cpu() for p in module.parameters()
                          if p.grad is not None])

    return losses, flat(state.model), flat(state.disc), seconds


def phase_gan():
    """config_swingan.yaml through GANTrainer on the card: the Swin
    generator (config_swin's, remat and stochastic depth on) and the
    PatchGAN discriminator, one warm-up and GAN_STEPS timed steps at batch 1,
    the discriminator's device time as its own group; val_step and a GAN
    checkpoint served through Reconstructor; one step at 1 unroll held
    against the port's CPU path."""
    cfg = swingan_cfg(output_dir=str(RUNS))
    cfg.freeze()
    trainer = GANTrainer(cfg)                   # the GPU: no device given
    check(trainer.device.type == "cuda", f"GANTrainer on {trainer.device}")
    batches = _train_batches("gan", cfg, trainer, GAN_STEPS + 1)
    state = trainer.init_state(state_dict=init_params(cfg, SEED))
    forward = state.disc.forward

    def annotated(x):
        with torch.profiler.record_function("discriminator"):
            return forward(x)

    state.disc.forward = annotated
    counts, _, _, _ = _timed_steps("gan", trainer, state, batches,
                                   _train_launches(cfg), GAN_KEYS,
                                   split="discriminator")
    counts = {name: {"train steps": c["steps"]} for name, c in counts.items()}

    metrics, pred = trainer.val_step(state, batches[0])
    check(torch.isfinite(torch.view_as_real(pred)).all().item(),
          "gan val_step output not finite")
    shutil.rmtree(RUNS, ignore_errors=True)
    CheckpointManager(str(RUNS / "checkpoints")).save(state.step, state)
    recon = Reconstructor(cfg, load_checkpoint_params(str(RUNS / "checkpoints")))
    out = recon(batches[0])
    ref = (pred * torch.from_numpy(batches[0]["scale"]).cuda().reshape(
        -1, 1, 1, 1, 1)).cpu().numpy()
    rel_ck = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    val_l1 = float(metrics["Validate/complex_l1"])
    print(f"gan: val_step complex_l1 {val_l1:.6f}; the GAN checkpoint at "
          f"step {state.step} (generator, discriminator, both optimizers) "
          f"through load_checkpoint_params and Reconstructor vs val_step: "
          f"rel L2 {rel_ck:.3e}")
    check(rel_ck <= 1e-6, f"GAN checkpoint reconstruction rel L2 {rel_ck:.3e}")
    del trainer, state, recon
    torch.cuda.empty_cache()

    cut = _cut(cfg, 1)
    params = init_params(cut, SEED)
    gpu = _gan_step(cut, params, batches[0], "cuda")
    cpu = _gan_step(cut, params, batches[0], "cpu")
    rels = {k: abs(gpu[0][k] - cpu[0][k]) / abs(cpu[0][k]) for k in GAN_KEYS}
    grads = {name: ((g - c).norm() / c.norm()).item()
             for name, g, c in (("generator", gpu[1], cpu[1]),
                                ("discriminator", gpu[2], cpu[2]))}
    print("gan: one step at 1 unroll, stochastic depth off, vs the port's "
          f"CPU path ({cpu[3]:.1f} s on the CPU): "
          + ", ".join(f"{k.split('/')[-1]} {gpu[0][k]:.6f} vs {cpu[0][k]:.6f}"
                      f" (rel {rels[k]:.3e})" for k in GAN_KEYS)
          + "; gradient rel L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in grads.items()))
    for k, r in rels.items():
        check(r <= TRAIN_LOSS_REL_TOL, f"gan GPU vs CPU {k} rel {r:.3e}")
    for n, r in grads.items():
        check(r <= TRAIN_GRAD_REL_L2_TOL,
              f"gan GPU vs CPU {n} gradient rel L2 {r:.3e}")
    shutil.rmtree(RUNS, ignore_errors=True)
    return counts


def _close(tag, key, got, ref, rtol, atol_rel):
    """A device tensor within rtol of a numpy array elementwise, with an
    absolute floor of atol_rel x max(max |ref|, 1) (the rule of
    np.testing.assert_allclose); returns (max abs error, max |ref|)."""
    diff = np.abs(got.cpu().numpy() - ref)
    mag = float(np.abs(ref).max())
    atol = atol_rel * max(mag, 1.0)
    excess = float((diff - (atol + rtol * np.abs(ref))).max())
    err = float(diff.max())
    check(excess <= 0, f"{tag}: {key} max abs err {err:.3e} (max |ref| "
          f"{mag:.3e}) outside rtol {rtol}, atol {atol:.3e}")
    return err, mag


def _pipe_build(tag, cfg, record, lr_decom=False):
    """One seeded device build of a record's first slice on the card, and
    the host CinePreprocess of it: the masks bit for bit. Returns (device
    batch, host example, device ms, host ms)."""
    name, k, m, t = record[0], record[1][0], record[2][0], record[3][0]
    t0 = time.perf_counter()
    host = CinePreprocess(cfg, use_seed=True, lr_decom=lr_decom)(k, m, t, name)
    host_ms = (time.perf_counter() - t0) * 1e3
    pipe = DevicePipeline(cfg, use_seed=True, lr_decom=lr_decom)  # the GPU
    check(pipe.device.type == "cuda", f"{tag}: pipeline on {pipe.device}")
    raw = pipe.upload_raw(k, m)
    params = pipe.draw_params(name, k.shape)
    got = pipe.build(raw, params)
    check(all(v.device.type == "cuda" for v in got.values()),
          f"{tag}: a batch tensor off the card")
    mask_equal = np.array_equal(got["mask"][0].cpu().numpy(), host["mask"])
    print(f"{tag}: slice [{','.join(map(str, k.shape))}] of {name}, crop "
          f"start {int(params['xs'])}, flips "
          f"{params['flips'].astype(int).tolist()}; mask bit-equal to the "
          f"host's: {mask_equal} ({int(host['mask'].sum())} samples)")
    check(mask_equal, f"{tag}: device mask differs from the host's")
    build_ms = cuda_ms(lambda: pipe.build(raw, params), runs=10)
    return got, host, build_ms, host_ms


def pipeline_parity(cfg, record):
    """(a): one seeded build against the host CinePreprocess."""
    got, host, build_ms, host_ms = _pipe_build("pipeline (a)", cfg, record)
    scale_rel = abs(float(got["scale"][0]) - float(host["scale"])) / abs(
        float(host["scale"]))
    check(got["scale"].shape == (1,) and scale_rel <= PIPE_SCALE_RTOL,
          f"pipeline (a): scale rel {scale_rel:.3e}")
    parts = [f"scale rel {scale_rel:.3e}"]
    for key in ("kspace", "maps", "target", "init_image"):
        check(tuple(got[key].shape) == (1,) + host[key].shape,
              f"pipeline (a): {key} {tuple(got[key].shape)}")
        err, mag = _close("pipeline (a)", key, got[key][0], host[key],
                          PIPE_RTOL, 2e-5)
        parts.append(f"{key} max abs err {err:.3e} of {mag:.3e}")
    print(f"pipeline (a): vs the host CinePreprocess (rtol {PIPE_RTOL}): "
          + "; ".join(parts) + f"; device build {build_ms:.3f} ms (CUDA "
          f"events), host preprocess {host_ms:.1f} ms (host clock)")


def pipeline_lr_decom(cfg, record):
    """(b): the build with lr_decom; L R^H against the host's, and the
    batched SVD timed on the card."""
    got, host, build_ms, host_ms = _pipe_build("pipeline (b)", cfg, record,
                                               lr_decom=True)
    p = cfg.MODEL.PARAMETERS
    image_shape = (1,) + host["target"].shape
    device = got["init_image"].device
    ours = compose(got["L_init"][0], got["R_init"][0],
                   BlockOp(p.DSLR.BLOCK_SIZE, image_shape, device=device))
    ref = compose(host["L_init"], host["R_init"],
                  BlockOp(p.DSLR.BLOCK_SIZE, image_shape, xp=np))
    err, mag = _close("pipeline (b)", "L R^H", ours, ref, PIPE_LR_RTOL, 2e-4)
    blocks = BlockOp(p.DSLR.BLOCK_SIZE, got["init_image"].shape,
                     device=device).extract(got["init_image"])
    svd_ms = cuda_ms(lambda: decompose(blocks, p.DSLR.NUM_BASIS), runs=10)
    print(f"pipeline (b): lr_decom, {p.DSLR.BLOCK_SIZE}x{p.DSLR.BLOCK_SIZE} "
          f"blocks, {p.DSLR.NUM_BASIS} basis vectors: L R^H vs the host's "
          f"max abs err {err:.3e} of {mag:.3e} (rtol {PIPE_LR_RTOL}); "
          f"torch.linalg.svd of {tuple(blocks.shape)} complex64 blocks "
          f"{svd_ms:.3f} ms (CUDA events); device build {build_ms:.3f} ms, "
          f"host preprocess with its numpy SVD {host_ms:.1f} ms")


def _loader_steps(tag, trainer, state, loader, nsense):
    """PIPE_WARMUP, then PIPE_STEPS timed Trainer steps fed by `loader`
    (epochs repeated), with the SENSE-normal launches checked; then
    PIPE_PROFILE_STEPS profiled steps (their device busy share printed).
    Returns (launches in the timed steps, steps/s, seconds)."""
    def batches():
        while True:
            yield from loader

    it = batches()
    try:
        for _ in range(PIPE_WARMUP):
            trainer.train_step(state, next(it))
        torch.cuda.synchronize()
        zero_counts()
        losses = []
        t0 = time.perf_counter()
        for _ in range(PIPE_STEPS):
            losses.append(trainer.train_step(state, next(it))[
                "Train/complex_l1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        losses = [float(x) for x in losses]
        check(np.isfinite(losses).all(), f"{tag}: losses {losses}")
        for name, n in counts.items():
            want = nsense * PIPE_STEPS if name == "sense_normal" else 0
            check(n == want, f"{tag}: {n} {name} launches in {PIPE_STEPS} "
                  f"steps, expected {want}")
        profile_device(
            f"{tag}: {PIPE_PROFILE_STEPS} steps",
            lambda: [trainer.train_step(state, next(it))
                     for _ in range(PIPE_PROFILE_STEPS)])
    finally:
        it.close()
    return counts, PIPE_STEPS / seconds, seconds


def pipeline_loaders(cfg, files, counts):
    """(c): Trainer steps fed by the host DataLoader and by the device
    pipeline, each built by `Trainer._train_loader` as fit builds it (the
    host one with DEVICE_PIPELINE off); the launches into `counts`."""
    dtype = cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE
    trainer = Trainer(cfg)                      # the GPU: no device given
    check(trainer.device.type == "cuda", f"Trainer on {trainer.device}")
    check(trainer._use_device_pipeline(), "DEVICE_PIPELINE not selected")
    state = trainer.init_state(state_dict=init_params(cfg, SEED))
    nsense = 2 * cfg.MODEL.PARAMETERS.NUM_UNROLLS - 1
    host_cfg = cfg.clone()
    host_cfg.defrost()
    host_cfg.DATALOADER.DEVICE_PIPELINE = False
    host_cfg.freeze()
    host = Trainer(host_cfg)._train_loader(None, files)
    check(isinstance(host, DataLoader), f"host leg got {type(host)}")
    t0 = time.perf_counter()
    pipe = trainer._train_loader(None, files)
    check(isinstance(pipe, DevicePipelineLoader), f"pipeline got {type(pipe)}")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    rates = {}
    for label, loader in (("host loader", host), ("pipeline", pipe)):
        tag = f"pipeline (c) {dtype} {label}"
        launched, rates[label], seconds = _loader_steps(
            tag, trainer, state, loader, nsense)
        for name, n in launched.items():
            counts[name][f"{label} steps {dtype}"] = n
        print(f"{tag}: {rates[label]:.3f} steps/s ({PIPE_STEPS} steps in "
              f"{seconds:.3f} s), {launched['sense_normal'] // PIPE_STEPS} "
              "sense_normal launches per step")
    print(f"pipeline (c) {dtype}: {len(pipe)} slices uploaded in "
          f"{upload_s:.2f} s; the pipeline "
          f"{rates['pipeline'] / rates['host loader']:.2f}x the host "
          "loader's steps/s")
    del trainer, state, pipe
    torch.cuda.empty_cache()


def phase_pipeline():
    """The device-resident input pipeline on the card: (a) and (b) against
    the host CinePreprocess, (c) both loaders feeding Trainer, with the SE
    row's float32 trunk and with a bfloat16 one (a step short enough that
    the host loader bounds it)."""
    dslr = dslr_cfg().MODEL.PARAMETERS.DSLR
    cfgs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = quality_cfg(dtype, model="se")
        cfg.OUTPUT_DIR = str(RUNS)
        cfg.MODEL.PARAMETERS.DSLR.BLOCK_SIZE = dslr.BLOCK_SIZE
        cfg.MODEL.PARAMETERS.DSLR.NUM_BASIS = dslr.NUM_BASIS
        cfg.freeze()
        cfgs[dtype] = cfg
    t0 = time.perf_counter()
    files = quality_split("train", PIPE_FILES)
    print(f"pipeline: {PIPE_FILES} quality-set train files "
          f"({sum(len(f[1]) for f in files)} slices) made in "
          f"{time.perf_counter() - t0:.1f} s")
    pipeline_parity(cfgs["float32"], files[0])
    pipeline_lr_decom(cfgs["float32"], files[0])
    counts = {name: {} for name in COUNTERS}
    for cfg in cfgs.values():
        pipeline_loaders(cfg, files, counts)
    return counts


def _entry(name, source, replaces, res, launches):
    """One kernel's item of the `kernels` line: the numbers of its headline
    variant, then every variant it was measured at."""
    head = res[next(iter(res))]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(sum(by_bs.values()) for by_bs in launches.values()),
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "rel_err": head["rel_err"],
        "launches_by_path": launches,
        "variants": {str(key): value for key, value in res.items()},
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    phase_device()
    phase_build()
    kres = phase_kernels()
    counts = {"main": phase_main(), "swin": phase_swin(),
              "train": phase_train(), "dslr": phase_dslr(),
              "headline": phase_headline(), "se": phase_se(),
              "modl": phase_modl(), "gan": phase_gan(),
              "pipeline": phase_pipeline()}

    def by_path(name):
        return {path: c[name] for path, c in counts.items()}

    def llr_by_path():
        return {path: {f"{side} {run}": n for side in ("pre", "post")
                       for run, n in c[f"llr_normal_{side}"].items()}
                for path, c in counts.items()}

    kernels = [
        _entry("sense_normal",
               "dl_swin_gan_tpu_torch/kernels/csrc/sense_normal.cu",
               "dl_swin_gan_tpu/kernels/sense_normal.py:125",
               {f"B={B}": r for B, r in kres["sense_normal"].items()},
               by_path("sense_normal")),
        _entry("window_attention",
               "dl_swin_gan_tpu_torch/kernels/csrc/window_attn.cu",
               "dl_swin_gan_tpu/kernels/window_attn.py:122",
               {f"B={B} mask={'shift' if m else 'none'}": r
                for (B, m), r in kres["window_attention"].items()},
               by_path("window_attention")),
        _entry("window_attention_bwd",
               "dl_swin_gan_tpu_torch/kernels/csrc/window_attn_bwd.cu",
               "dl_swin_gan_tpu/kernels/window_attn.py:148",
               {f"B={B} mask={'shift' if m else 'none'}": r
                for (B, m), r in kres["window_attention_bwd"].items()},
               by_path("window_attention_bwd")),
        _entry("llr_normal",
               "dl_swin_gan_tpu_torch/kernels/csrc/llr_normal.cu",
               "dl_swin_gan_tpu/kernels/llr_normal.py:282",
               {f"{side} S={S}": r
                for (side, S), r in kres["llr_normal"].items()},
               llr_by_path()),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
