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
              normal op, 'pre' and 'post', one and two systems, and at the
              quality set's served slice, 18x156x96), with its
              time, the plain version's, the PyTorch library call's, and its
              bound (at the 3xTF32 tensor-core rate, with the fp32-FMA
              figure beside it; their device times by launch from
              torch.profiler); the coil pass's blocks per SM at 180x64 (two
              at least) and the attention forward's at full width; the
              backwards and the block-LLR op also called twice for
              bitwise-equal results; both window-attention kernels with
              bfloat16 q, k, v (and g) at the Swin block's shapes and at
              SwinDiff's head_dim 24, against their plain versions, the
              float32 kernels on the same values, SDPA in bfloat16, and
              their bounds at the bf16 rate; the blocks per SM of each
              bf16 launch, the bf16 backward's device time by launch and
              its extra peak memory (no [W, H, N, N] scratch)
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
  8. dslr_serve DSLR serving, dslr-pgd and the RNN temporal nets at
              config_dslr.yaml's widths: 3 slices of exam 000 of the
              quality set (18x156x96, 8 coils, 2 maps) served at 12x by
              LRReconstructor on cuda, one slice per call, with cg-v1 (110
              'pre' block-LLR launches a slice) and with dslr-pgd (5, one a
              unroll), and nothing else launched; ms per slice (median of
              the 3, after a warm-up), one slice's device time by group,
              slice 0 held against the port's CPU path; the cg-v1 slices
              also written by reconstruct_exam (the H5 front end's body)
              and the CFL read back. dslr-pgd through DSLRTrainer: 1 warm-up and 4 timed
              steps, 5 'pre' and 4 'post' launches per step (the first
              unroll's L0 R0^H sees no parameter), one step at 2 unrolls
              against the CPU. An UnrolledLR with use_rnn_temporal (no
              config reaches it) at 2 unrolls: 1 warm-up and RNN_STEPS
              timed steps, one step against the CPU (cuDNN's LSTM with TF32
              off)
  9. headline the RES main path closed: the port bench's train step
              (dl_swin_gan_tpu_torch.bench, Trainer.train_step on a resident
              batch) at batch 16 with remat in bfloat16 and float32 and at
              batch 1 in bfloat16, 1 warm-up and 3 timed steps each, 9
              SENSE-normal launches per step asserted, peak memory, one
              step's device time by kernel group; one bfloat16 step at 1
              unroll held against the port's CPU bfloat16 step; main's 4
              slices served with the bfloat16 trunk and scored by the
              port's evaluator (SSIM, PSNR) against their 1x adjoint; a CFL
              round trip through reconstruct_cfl against Reconstructor
 10. se       configs/config_se.yaml (5 unrolls x 1 resblock x 384
              features, SE gate of hidden width 16) served like main (5
              SENSE-normal launches per batch), the CPU comparison at 1
              unroll; 1 warm-up and 3 timed Trainer steps at its readout
              crop of 48 (9 SENSE-normal launches per step), one step at 1
              unroll held against the port's CPU step; the CBAM trunk served
              at configs/quality/cbam.yaml's widths (1 x 96 features)
 11. modl     the example config with META_ARCHITECTURE modl (the hqs rule,
              10 CG steps per unroll) served like main: 5 x (1 + 10) = 55
              SENSE-normal launches per batch, and the SENSE kernel's share
              of a slice's device time (printed for every served path)
 12. gan      configs/config_swingan.yaml through GANTrainer: the Swin
              generator (remat, stochastic depth) and the PatchGAN
              discriminator, 1 warm-up and 3 timed steps at batch 1 (60
              window-attention, 30 backward and 9 SENSE-normal launches per
              step, one generator forward), the discriminator, adversarial
              and reconstruction losses, one step's device time by group
              with the discriminator as its own; val_step and the GAN
              checkpoint served through Reconstructor; one step at 1 unroll,
              stochastic depth off, held against the port's CPU step
 13. pipeline the device-resident input pipeline (data/device_pipeline.py)
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
 14. diffusion the DDPM_X diffusion paths (no SENSE-normal or LLR launch:
              their DC step calls the SENSE forward and adjoint): (a) Latte
              at configs/quality/latte2.yaml's full widths (2 shared
              unrolls, 12 layers, 192 hidden, 6 heads, patch 4; seeded
              random weights, the zero-init layers included) served by
              DiffusionReconstructor on main's 4 slices at DIFF_SAMPLE_STEPS
              sampling steps, batch 1 and 4, ms per slice and peak memory,
              one 2-step sampling run's device time by group; one slice at
              2 steps held against the port's CPU path with the same noise;
              (b) DiffusionTrainer at the quality geometry through the
              device pipeline (its diffusion batches): 1 warm-up and
              DIFF_TRAIN_STEPS timed steps at batch 1, one profiled step
              (busy share), DIFF_DRAW_ROUNDS alternating rounds of steps
              with t and noise drawn on the card and drawn on the host
              and copied in, one step held against the CPU path on the
              same t and noise (loss 1e-4; gradients, and the change of an
              EMA of decay DIFF_CHECK_EMA_DECAY against its rule on each
              device and against the CPU's, 1e-3); (c)
              configs/quality/dit.yaml: 1 warm-up and 1 timed train step
              and a DIFF_SHORT_STEPS sampling run; (d) SwinDiff (1
              swinblock of SWINDIFF_LAYERS layers, 96 features, 4 heads, 2
              shared unrolls): a served batch of 4 (window-attention
              launches: sampling steps x unrolls x layers, asserted), its
              slice 0 against the CPU path, and one train step (forward
              and backward launches per unroll and layer, asserted) held
              against the CPU path as in (b) but for the EMA's change
              against the CPU's (its cuDNN gradient agrees to 5e-5 to
              2e-4, which Adam's first step makes 5e-3 to 1e-2); the
              window-attention inputs of that step (head_dim 24, unshifted
              and shifted) through the forward and backward kernels
              against their plain versions, added to the kernels line as
              the "swindiff train" variants
 15. swin_bf16 config_swin.yaml with CONV_BLOCK.DTYPE bfloat16 (full
              width): served at batch 1 and 4 like swin (30 window-attention
              launches per batch, bf16 q, k, v); 1 warm-up and
              SWIN_BF16_TRAIN_STEPS timed Trainer steps at batch 1 (60 / 30
              / 9 launches per step, asserted), one profiled; one step at 1
              unroll on SWIN_BF16_CPU_FRAMES frames against the CPU path
 16. diffusion_bf16 configs/quality/dit_bf16.yaml: 1 warm-up and
              DIFF_BF16_STEPS timed DiffusionTrainer steps through the
              device pipeline, and a DIFF_SHORT_STEPS sampling run (slice 0
              at 2 steps against the CPU path); Latte at latte2.yaml's
              widths in bfloat16: DIFF_BF16_STEPS timed train steps, one held
              against the CPU path
 17. multigpu the mesh (parallel/mesh.py) on every card of the machine, one
              NCCL rank a card (spawned after the build; with one card,
              rank 0 runs in this process, as a spawn would add its
              start-up to the phase): (a) the example
              config at full width, one slice a rank, under HSDP (data =
              world) and under MODEL.STRATEGY fsdp, each step's loss and
              gradients against the unwrapped Trainer step on this
              process's card (1e-4 / 1e-3 rel L2), ms per step wrapped and
              unwrapped, 9 SENSE-normal launches per step asserted; (b)
              the bf16 Swin step with the tensor-parallel plan at model =
              world (60 / 30 / 9 launches per step) against the unwrapped
              one (the bf16 trunk's limits); (c) a data-parallel
              Reconstructor at B=4 against the plain one (1e-5); (d)
              window_attention_sharded at the Swin block's shapes, with
              the shift mask and without, against the unsharded kernel on
              the rank's windows; (e) the rank body of
              entry.dryrun_multichip(world, "nccl") on the same ranks, its
              launches counted; (f) two gloo ranks with CUDA tensors on
              card 0, HSDP over data=2, one slice each, against the
              unwrapped step at B=2. On a one-card machine the NCCL rank
              count is 1, so (f) is the multi-rank check there
 18. compact  serving over the acquired-lines wire (infer/compact.py):
              (a) the native VDkt library (ops/native.py, built by cc) is
              loaded and used, and its masks equal the Python path's bit for
              bit (the 12x serving mask at 20x180x64, a name-tuple seed, a
              partial-ky mask), host ms per mask on each path; (b) main's 4
              slices at 12x through CompactTransform and CompactReconstructor
              over the dict, flat float32 and flat float16 wires at batch 4
              (5 SENSE-normal launches per batch, asserted), against the
              dense Reconstructor fed by ResampleTransform(12) (dict within
              the JAX package's compact tolerance, flat float32 equal to
              dict, float16 within 5e-3 of the largest magnitude), slice 0
              against the port's CPU compact path, MB per slice on each
              wire; (c) the port bench's end-to-end serving (recon_e2e and
              the three compact wires, interleaved, 16 slices, best of 3):
              frames/s, and beside it the host transform ms per slice, the
              host-to-device ms and one profiled slice's device ms
 19. result   one JSON line of kernels (the bf16 window-attention variants
              under window_attention and window_attention_bwd), then the
              last line {"ok": true, "device": {...}}

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
    QUALITY_SET, make_cine_example, quality_split,
)
from dl_swin_gan_tpu_torch.infer.compact import (
    CompactReconstructor, CompactTransform, FlatWire, pad_lines, wire_bytes,
)
from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_volumes
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    DiffusionReconstructor, LRReconstructor, Reconstructor, accel_transform,
    batched, load_checkpoint_params, reconstruct_cfl, reconstruct_exam,
    reconstruct_examples,
)
from dl_swin_gan_tpu_torch.infer.transforms import (
    PARITY_SEED, InferenceTransform, ResampleTransform,
)
from dl_swin_gan_tpu_torch.kernels import _build
from dl_swin_gan_tpu_torch.kernels import llr_normal as LN
from dl_swin_gan_tpu_torch.kernels import sense_normal as SN
from dl_swin_gan_tpu_torch.kernels import window_attn as WA
from dl_swin_gan_tpu_torch.models import swin as swin_module
from dl_swin_gan_tpu_torch.models.swin import compute_shift_mask
from dl_swin_gan_tpu_torch.ops.llr import (
    BlockOp, compose, decompose, decompose_init,
)
from dl_swin_gan_tpu_torch.ops import masks as masks_module
from dl_swin_gan_tpu_torch.ops import native
from dl_swin_gan_tpu_torch.ops.masks import VDktMaskFunc
from dl_swin_gan_tpu_torch.ops.sense import _adjoint_impl, _forward_impl
from dl_swin_gan_tpu_torch.models.swin import DropPath
from dl_swin_gan_tpu_torch.solvers.dslr import build_dslr_solver
from dl_swin_gan_tpu_torch.train import (
    CheckpointManager, DiffusionTrainer, DSLRTrainer, GANTrainer, Trainer,
)
from dl_swin_gan_tpu_torch.entry import dryrun_rank
from dl_swin_gan_tpu_torch.parallel.launch import run_ranks
from dl_swin_gan_tpu_torch.parallel.mesh import (
    full_tensor, make_mesh, unpermute_qkv,
)
from dl_swin_gan_tpu_torch.utils.device import use_ieee_fp32
from dl_swin_gan_tpu_torch.utils.headline import (
    dslr_cfg, dslr_pgd_cfg, headline_cfg, headline_shape, quality_cfg,
    se_cfg, swin_cfg, swingan_cfg,
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
# the quality set's served slice (T, Y, X, C, E): the block-LLR kernel's
# serving geometry; the DSLR slices served (timed) per mode; the timed
# train steps of the RNN temporal nets
SERVE_SHAPE = tuple(QUALITY_SET[k] for k in "TYXCE")
SERVE_SLICES = 3
RNN_STEPS = 3
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
# the diffusion phase: sampling steps of the served Latte (the
# DiffusionReconstructor's default), timed train steps, the short DiT and
# SwinDiff sampling runs, the SwinDiff trunk's depth, and the scale of the
# seeded random weights (the adaLN and final layers are zero at init)
DIFF_SAMPLE_STEPS = 100
DIFF_TRAIN_STEPS = 4
DIFF_SHORT_STEPS = 3
SWINDIFF_LAYERS = 2
DIFF_WEIGHT_NOISE = 0.02
# the EMA decay of the GPU-vs-CPU train step: at the trainer's 0.9999 one
# step moves the EMA by 1e-4 of the update, below float32's resolution of
# the weights, so the check compares the EMA's change at a decay that moves
# it visibly
DIFF_CHECK_EMA_DECAY = 0.5
# rounds of the Latte steps with t and noise drawn on the card against
# drawn on the host and copied in (alternating, over the timed batches)
DIFF_DRAW_ROUNDS = 4
# reconstruct_cfl vs Reconstructor on the same scanner arrays: the same
# inputs through the same solver
CFL_REL_L2_TOL = 1e-6
# the swin_bf16 phase's timed train steps; the diffusion_bf16 phase's timed
# DiT and Latte steps
SWIN_BF16_TRAIN_STEPS = 3
DIFF_BF16_STEPS = 3
# the frames of the swin_bf16 step held against the CPU (all 20 took the
# card's host 20 s)
SWIN_BF16_CPU_FRAMES = 8
# the bfloat16 window-attention kernels against their plain versions: both
# take q, k, v (and g) at their exact values (the plain versions widen them,
# the kernels' bf16 products are exact, p and ds go in as two bf16 terms) and
# round only the outputs, and their float32 values differ by the float32
# kernels' KERNEL_REL_TOL, so each
# rounded element is within one bf16 ulp (of the larger magnitude) plus
# KERNEL_REL_TOL of the largest element; rel L2 over all within
# BF16_KERNEL_REL_L2 (a kernel that multiplied in bf16 or rounded p first is
# 4e-3 to 5e-3 away on the CPU, tests/test_torch_window_attn.py); dbias is
# float32, held to KERNEL_REL_TOL
BF16_KERNEL_REL_L2 = 5e-4
# a bfloat16 trunk's train step (Swin at 1 unroll, Latte) on the card
# against the port's CPU path: other conv, GEMM and attention kernels sum in
# other orders, so a few bf16 roundings go the other way. The H100 showed
# loss rel 2.8e-6 and 4.4e-6, gradient rel L2 1.7e-3 and 1.0e-3 (the Swin
# step on all 20 frames); the limits are the bf16 RES step's loss limit and
# 6x the larger gradient
BF16_TRUNK_LOSS_REL_TOL = BF16_LOSS_REL_TOL
BF16_TRUNK_GRAD_REL_L2_TOL = 1e-2
# the multigpu phase: wrapped (FSDP2, DTensor) steps against the unwrapped
# step on the same card and batch, held to the train step's limits
# (TRAIN_*; the bf16 Swin step to the bf16 trunk's)
MG_STEPS = 2
MG_GLOO_UNROLLS = 2   # the depth of the gloo ranks' steps (the phase's time)
MG_RECON_REL_TOL = 1e-5
MG_ATTENTION_ABS_TOL = 1e-6   # the same kernel on the same windows
# the compact phase: the VDkt cases held native against Python (tag, mask
# shape, accelerations, partial kx, partial ky, seed) and the timed calls
# per path; the compact wires against the dense path
# (tests/test_compact_transfer.py: rtol 2e-3, atol 2e-4 of the largest
# magnitude; float16 5e-3 of it); the end-to-end variants
COMPACT_VDKT_CASES = (
    ("serving 12x 20x180x64", (1, 1, 20, 180, 64), (12, 12), 0.25, 0.0,
     PARITY_SEED),
    ("name seed 18x80x64", (1, 1, 18, 80, 64), (10, 15), 0.25, 0.0,
     tuple(map(ord, "patient_003.h5"))),
    ("partial ky 12x80x32", (1, 1, 12, 80, 32), (10, 15), 0.25, 0.25, 5),
)
COMPACT_VDKT_RUNS = 20
COMPACT_RTOL, COMPACT_ATOL = 2e-3, 2e-4
COMPACT_F16_ATOL = 5e-3
E2E_VARIANTS = ("dense",) + bench.E2E_WIRES
# published H100 SXM peaks (NVIDIA data sheet) for the bound
FP32_FLOPS = 67e12        # float32 outside the tensor cores
TF32_FLOPS = 495e12       # dense TF32 on the tensor cores; 3xTF32 runs at 1/3
BF16_FLOPS = 989e12       # dense bf16 on the tensor cores
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
            "window_attention_bf16": kernels_window_attention_bf16(),
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
    times = per_call(device_ms_by_kernel(fn))
    return {_short(n): t for n, t in times.items() if "coil_" in n}


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


def _attention_work(W, H, N, D, nW, io_bytes=4):
    """(FLOP, bytes) of one window-attention call: the two products, and
    q, k, v, out (io_bytes each element), bias and the mask (float32) each
    moved once."""
    flops = 4 * W * H * N * N * D
    nbytes = (io_bytes * 4 * W * H * N * D
              + 4 * (H * N * N + (nW * N * N if nW else 0)))
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
            device_ms = sum(per_call(device_ms_by_kernel(
                lambda: WA.window_attention(q, k, v, bias, m))).values())
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


def _attention_bwd_work(W, H, N, D, nW, io_bytes=4):
    """(FLOP, bytes) of one window-attention backward: the five products
    (s, dp, dv, dq, dk); q, k, v, g in, dq, dk, dv out (io_bytes each
    element), bias in, dbias out and the mask in (float32), each moved
    once."""
    flops = 10 * W * H * N * N * D
    nbytes = (io_bytes * 7 * W * H * N * D
              + 4 * (2 * H * N * N + (nW * N * N if nW else 0)))
    return flops, nbytes


def device_ms_by_kernel(fn, runs=10, tries=3):
    """{kernel name: (device ms per launch, launches per fn() call)} from
    torch.profiler over runs back-to-back calls (L2 warm), after one call
    outside the profile. Each kernel's time is over its own count of
    launches, so it reads right where a profile lost events; a profile
    that came back empty or lost events (a count that is not a multiple of
    runs), as happens now and then on the card's machine, is taken again,
    tries in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events and all(e.count % runs == 0 for e in events):
            break
    return {e.key: (e.self_device_time_total / 1e3 / e.count, e.count / runs)
            for e in events}


def per_call(times):
    """{kernel name: device ms per fn() call} of device_ms_by_kernel's
    {name: (ms per launch, launches per call)}."""
    return {n: ms * k for n, (ms, k) in times.items()}


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
    full = full.expand(W, H, N, N).to(q.dtype).contiguous().requires_grad_(
        True)
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
            out, lse, _ = WA.window_attention_fwd(q, k, v, bias, m)

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
            lib_kernels = per_call(device_ms_by_kernel(library))
            backend = _sdpa_backend(lib_kernels)
            lib_dq = library()[0]
            lib_rel = ((lib_dq - plain[0]).abs().max()
                       / plain[0].abs().max()).item()
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(
                lambda: WA.window_attention_bwd_plain(q, k, v, bias, m, g))
            library_ms = cuda_ms(library)
            launches = {_short(n): t for n, t in
                        per_call(device_ms_by_kernel(kernel)).items()}
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


def _bf16_errors(a, b):
    """(max abs error, rel L2, and the largest excess over one bf16 ulp plus
    KERNEL_REL_TOL of the largest element, which must be <= 0) of bf16 a
    against bf16 b, in float32."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(
        mag > 0, mag, torch.ones_like(mag)))) - 7)
    diff = (a - b).abs()
    excess = (diff - ulp - KERNEL_REL_TOL * b.abs().max()).max().item()
    return (diff.max().item(), ((a - b).norm() / b.norm()).item(), excess)


def _bf16_attention_cases():
    """(tag, W, H, N, D, mask or None): the full-width Swin block at batch 1
    and 4, shifted and not, and SwinDiff's window at head_dim 24 (7 frames
    shrunk to 6: N = 384), shifted by (0, 4, 4) on a 6x16x40 grid (10
    windows) and not."""
    swin = torch.from_numpy(compute_shift_mask(
        *SWIN_GRID, SWIN_WINDOW, SWIN_SHIFT)).cuda()
    swd = torch.from_numpy(compute_shift_mask(
        6, 16, 40, (6, 8, 8), (0, 4, 4))).cuda()
    N = SWIN_WINDOW[0] * SWIN_WINDOW[1] * SWIN_WINDOW[2]
    cases = [(f"B={B} mask={'shift' if m else 'none'}",
              swin.shape[0] * B, SWIN_HEADS, N, SWIN_HEAD_DIM,
              swin if m else None) for B in (1, 4) for m in (True, False)]
    cases += [(f"swindiff mask={'shift' if m else 'none'}", swd.shape[0], 4,
               384, 24, swd if m else None) for m in (True, False)]
    return cases


def extra_peak_mb(fn):
    """MB of device memory one fn() call allocates above what was allocated
    before it, at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del result
    return (peak - base) / 1e6


def kernels_window_attention_bf16():
    """Both window-attention kernels with bfloat16 q, k, v (and g): each
    against its plain version (bf16 outputs within one ulp; dbias and lse
    float32), the backward called twice for bitwise-equal gradients; timed
    against the float32 kernel on the same values widened, SDPA on the
    bf16 inputs with a bf16 float mask (forward, and backward with that
    mask requiring grad) and its plain version; its bound moves bf16 q, k,
    v, out (g, dq, dk, dv) and float32 bias, mask (dbias), and counts the
    products at the bf16 tensor-core rate, the 3xTF32 figure beside. The
    backward's delta reads the forward's float32 output (out32): the
    backward handed the rounded bf16 output instead shows what that choice
    buys. Beside them: the blocks per SM of each bf16 launch, the
    backward's device ms by launch and the extra peak memory of one
    backward call (no [W, H, N, N] scratch on the bf16 path). Returns
    ({tag: forward numbers}, {tag: backward numbers})."""
    rng = np.random.RandomState(SEED + 4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_res, bwd_res = {}, {}
    blocks = {D: {"forward": WA.blocks_per_sm(D, torch.bfloat16),
                  **WA.bwd_bf16_blocks_per_sm(D)}
              for D in sorted({c[4] for c in _bf16_attention_cases()})}
    print(f"kernel window_attention bf16: blocks per SM by head_dim and "
          f"launch {blocks}")
    for tag, W, H, N, D, mask in _bf16_attention_cases():
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (W, H, N, D)).astype(np.float32)).cuda().bfloat16()
            for _ in range(4))
        bias = torch.from_numpy(
            0.5 * rng.standard_normal((H, N, N)).astype(np.float32)).cuda()
        nW = 0 if mask is None else mask.shape[0]
        out, lse, out32 = WA.window_attention_fwd(q, k, v, bias, mask)

        def backward(o=out32):
            return WA.window_attention_bwd(q, k, v, bias, mask, g, o, lse)

        grads, again = backward(), backward()
        rounded = backward(out.float())      # delta from the bf16 output
        plain_out = WA.window_attention_plain(q, k, v, bias, mask)
        plain = WA.window_attention_bwd_plain(q, k, v, bias, mask, g)
        torch.cuda.synchronize()
        at = f"bf16 {tag} [{W},{H},{N},{D}]"
        check(torch.isfinite(out.float()).all().item()
              and torch.equal(out, out32.bfloat16()),
              f"window_attention {at}: out not finite or not out32 rounded")
        fwd_abs, fwd_rel, excess = _bf16_errors(out, plain_out)
        check(excess <= 0 and fwd_rel <= BF16_KERNEL_REL_L2,
              f"window_attention vs plain at {at}: rel L2 {fwd_rel:.3e}, "
              f"{excess:.3e} past one ulp")
        rels, bwd_abs, delta_rels = {}, 0.0, {}
        for name, a, b, c, r in zip(("dq", "dk", "dv", "dbias"), grads, plain,
                                    again, rounded):
            check(torch.isfinite(a.float()).all().item() and torch.equal(a, c),
                  f"backward {name} not finite or not repeatable at {at}")
            if name == "dbias":
                err = (a - b).abs().max().item()
                rels[name] = err / b.abs().max().item()
                ok = rels[name] <= KERNEL_REL_TOL
                delta_rels[name] = ((r - b).abs().max()
                                    / b.abs().max()).item()
            else:
                err, rels[name], excess = _bf16_errors(a, b)
                ok = excess <= 0 and rels[name] <= BF16_KERNEL_REL_L2
                delta_rels[name] = _bf16_errors(r, b)[1]
            bwd_abs = max(bwd_abs, err)
            check(ok, f"backward {name} vs plain at {at}: rel "
                  f"{rels[name]:.3e}")

        wide = [t.float() for t in (q, k, v, g)]
        f32_out, f32_lse, _ = WA.window_attention_fwd(*wide[:3], bias, mask)
        full = bias[None] + (mask.repeat(W // nW, 1, 1)[:, None] if nW
                             else 0)
        full = full.expand(W, H, N, N).bfloat16().contiguous()
        library_bwd = sdpa_backward(q, k, v, bias, mask, g)
        for res, work, kernel, f32_kernel, plain_fn, library_fn, max_abs, \
                rel in (
                (fwd_res, _attention_work,
                 lambda: WA.window_attention_fwd(q, k, v, bias, mask,
                                                 with_lse=False),
                 lambda: WA.window_attention_fwd(*wide[:3], bias, mask,
                                                 with_lse=False),
                 lambda: WA.window_attention_plain(q, k, v, bias, mask),
                 lambda: sdpa(q, k, v, attn_mask=full), fwd_abs, fwd_rel),
                (bwd_res, _attention_bwd_work, backward,
                 lambda: WA.window_attention_bwd(*wide[:3], bias, mask,
                                                 wide[3], f32_out, f32_lse),
                 lambda: WA.window_attention_bwd_plain(q, k, v, bias, mask,
                                                       g),
                 library_bwd, bwd_abs, max(rels.values()))):
            flops, nbytes = work(W, H, N, D, nW, io_bytes=2)
            t_ops = flops / BF16_FLOPS * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            ms = cuda_ms(kernel)
            res[tag] = dict(
                max_abs_err=max_abs, rel_err=rel, ms=ms,
                f32_kernel_ms=cuda_ms(f32_kernel),
                plain_ms=cuda_ms(plain_fn), library_ms=cuda_ms(library_fn),
                bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                three_tf32_ops_ms=flops / (TF32_FLOPS / 3) * 1e3,
                bound_share=bound / ms, gflop=flops / 1e9,
                mbytes=nbytes / 1e6, dtype="bfloat16")
        bwd_res[tag]["rel_err_by_grad"] = rels
        bwd_res[tag]["rel_l2_with_delta_from_bf16_out"] = delta_rels
        bwd_res[tag]["device_ms_by_launch"] = {
            _short(n): ms
            for n, (ms, _) in device_ms_by_kernel(backward).items()}
        bwd_res[tag]["extra_peak_mb"] = extra_peak_mb(backward)
        fwd_res[tag]["blocks_per_sm"] = blocks[D]["forward"]
        bwd_res[tag]["blocks_per_sm"] = {n: b for n, b in blocks[D].items()
                                         if n != "forward"}
        fwd_res[tag]["train_forward_ms"] = cuda_ms(
            lambda: WA.window_attention_fwd(q, k, v, bias, mask))
        del library_bwd
        for what, r in (("window_attention", fwd_res[tag]),
                        ("window_attention_bwd", bwd_res[tag])):
            print(f"kernel {what} {at}: rel L2 vs plain {r['rel_err']:.3e} "
                  f"(max abs {r['max_abs_err']:.3e}) kernel_ms "
                  f"{r['ms']:.4f} f32 kernel_ms {r['f32_kernel_ms']:.4f} "
                  f"plain_ms {r['plain_ms']:.4f} library_ms (SDPA bf16) "
                  f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
                  f"({r['bound_by']} at the bf16 rate; 3xTF32 operations "
                  f"{r['three_tf32_ops_ms']:.4f}; {r['gflop']:.3f} GFLOP, "
                  f"{r['mbytes']:.2f} MB; {r['bound_share']:.1%} of the "
                  "bound)")
        print(f"kernel window_attention_bwd {at}: rel L2 by gradient "
              + ", ".join(f"{n} {x:.3e}" for n, x in rels.items())
              + "; with delta from the bf16-rounded out instead of out32: "
              + ", ".join(f"{n} {x:.3e}" for n, x in delta_rels.items())
              + f"; the forward with lse and out32 (training's) "
              f"{fwd_res[tag]['train_forward_ms']:.4f} ms; device ms by "
              "launch " + ", ".join(
                  f"{n} {t:.4f}"
                  for n, t in bwd_res[tag]["device_ms_by_launch"].items())
              + f"; extra peak memory of one call "
              f"{bwd_res[tag]['extra_peak_mb']:.1f} MB")
    return fwd_res, bwd_res


def kernels_attention_at(tag, masked, q, k, v, bias, mask):
    """The forward and backward window-attention kernels against their plain
    versions on the inputs a path gave them (a seeded cotangent for the
    backward): ({forward numbers}, {backward numbers}) as the kernels line's
    variants, with SDPA's forward and backward as the library call."""
    W, H, N, D = q.shape
    nW = mask.shape[0] if masked else 0
    g = torch.from_numpy(np.random.RandomState(SEED + 3).standard_normal(
        tuple(q.shape)).astype(np.float32)).cuda()
    out, lse, _ = WA.window_attention_fwd(q, k, v, bias, mask)

    def backward():
        return WA.window_attention_bwd(q, k, v, bias, mask, g, out, lse)

    grads, again = backward(), backward()
    plain_out = WA.window_attention_plain(q, k, v, bias, mask)
    plain = WA.window_attention_bwd_plain(q, k, v, bias, mask, g)
    torch.cuda.synchronize()
    at = f"{tag} [{W},{H},{N},{D}] mask={'shift' if masked else 'none'}"
    fwd_abs = (out - plain_out).abs().max().item()
    fwd_rel = fwd_abs / plain_out.abs().max().item()
    check(torch.isfinite(out).all().item() and fwd_rel <= KERNEL_REL_TOL,
          f"window_attention vs plain rel err {fwd_rel:.3e} at {at}")
    rels, bwd_abs = {}, 0.0
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), grads, plain,
                             again):
        check(torch.isfinite(a).all().item() and torch.equal(a, c),
              f"backward {name} not finite or not repeatable at {at}")
        err = (a - b).abs().max().item()
        rels[name] = err / b.abs().max().item()
        bwd_abs = max(bwd_abs, err)
        check(rels[name] <= KERNEL_REL_TOL, f"backward {name} vs plain rel "
              f"err {rels[name]:.3e} > {KERNEL_REL_TOL} at {at}")

    full = bias[None] + (mask.repeat(W // nW, 1, 1)[:, None] if masked
                         else 0)
    full = full.expand(W, H, N, N).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = sdpa_backward(q, k, v, bias, mask, g)
    results = []
    for work, kernel, plain_fn, library_fn, max_abs, rel in (
            (_attention_work,
             lambda: WA.window_attention_fwd(q, k, v, bias, mask,
                                             with_lse=False),
             lambda: WA.window_attention_plain(q, k, v, bias, mask),
             lambda: sdpa(q, k, v, attn_mask=full), fwd_abs, fwd_rel),
            (_attention_bwd_work, backward,
             lambda: WA.window_attention_bwd_plain(q, k, v, bias, mask, g),
             library, bwd_abs, max(rels.values()))):
        flops, nbytes = work(W, H, N, D, nW)
        t_ops = flops / (TF32_FLOPS / 3) * 1e3     # 3xTF32
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        ms = cuda_ms(kernel)
        results.append(dict(
            max_abs_err=max_abs, rel_err=rel, ms=ms,
            plain_ms=cuda_ms(plain_fn), library_ms=cuda_ms(library_fn),
            bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_share=bound / ms, gflop=flops / 1e9, mbytes=nbytes / 1e6))
    fwd, bwd = results
    bwd["rel_err_by_grad"] = rels
    for what, r in (("window_attention", fwd),
                    ("window_attention_bwd", bwd)):
        print(f"kernel {what} at {at}: max|k-p|/max|p| {r['rel_err']:.3e} "
              f"(max abs {r['max_abs_err']:.3e}) kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}; {r['bound_share']:.1%} of the bound)")
    return fwd, bwd


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


def llr_inputs(serving=False):
    """The block-LLR kernel's setting at the DSLR training point (20x180x64,
    a training mask), or with `serving` at the quality set's served slice
    (18x156x96, its 8 coils and 2 maps, the 12x mask at the parity seed):
    (op, maps, w2, c64, plain, library); c64(*shape) draws seeded complex64
    on the card, plain(blk, d_side) is the plain version and
    library(blk, d_side) the same function by PyTorch calls (BlockOp
    combine, the SENSE forward and adjoint on cuFFT, BlockOp extract)."""
    cfg = quality_cfg(model="dslr") if serving else dslr_cfg()
    T, Y, X, C, E = SERVE_SHAPE if serving else headline_shape()
    p = cfg.MODEL.PARAMETERS
    op = BlockOp(p.DSLR.BLOCK_SIZE, (1, E, T, Y, X), device="cuda")
    u = cfg.AUG_TRAIN.UNDERSAMPLE
    accels, seed = ((ACCEL, ACCEL), PARITY_SEED) if serving else (
        u.ACCELERATIONS, SEED)
    mask = VDktMaskFunc(accels, sim_partial_kx=u.PARTIAL_KX,
                        sim_partial_ky=u.PARTIAL_KY)((1, 1, T, Y, X), seed)
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
    two (the jacobi mode), the training mask; and at the served quality
    slice (18x156x96, the 12x mask): 'pre' and 'post', one system. Two
    calls must be bitwise equal."""
    results = {}
    for serving in (False, True):
        results.update(_kernels_llr_at(serving))
    return results


def _kernels_llr_at(serving):
    op, maps, w2, c64, plain, library = llr_inputs(serving)
    T, Y, X = w2.shape
    C = maps.shape[1]
    blocks = SN.blocks_per_sm(Y, X, LN._library())
    print(f"kernel llr_normal: coil_normal_kernel blocks per SM at {Y}x{X}: "
          f"{blocks}")
    check(blocks >= (1 if serving else 2),
          f"llr coil pass fits {blocks} block(s) per SM at {Y}x{X}")
    results = {}
    for S in ((1,) if serving else (1, 2)):
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
            tag = (f"serve {Y}x{X} " if serving else "") + f"{d_side} S={S}"
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
            results[tag] = dict(
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
             batch_invariant=True, batch_tol=1e-4, cpu_check=True):
    """Drive one reconstruction path through Reconstructor on the card and
    check it. `expected` maps each counter of COUNTERS to its launches per
    batch; returns ({counter: {batch size: launches}}, the raw slices, their
    examples, the batch-1 outputs, the weights, one slice's device ms by
    kernel group). The CPU comparison runs the config's unrolls, or
    `cpu_unrolls` of them (the same config cut, on both devices). A path
    whose output depends on the batch (`batch_invariant` False: the hqs
    rule's CG takes its step sizes from inner products over the whole
    batch, in the JAX package too) prints batch 1 against batch 4 instead
    of holding them to `batch_tol`. Without `cpu_check` the CPU
    comparison is left to the caller."""
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
        check(rel_b <= batch_tol,
              f"batch 1 vs batch 4 outputs differ: {rel_b:.3e}")

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

    if not cpu_check:
        return counts, slices, examples, outs[1], params, groups
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


def _dslr_pgd_launches(cfg):
    """Block-LLR normal launches of one dslr-pgd train step, from the code:
    one operator application per unroll; the first unroll's input L0 R0^H
    sees no parameter, so every later application runs its adjoint once in
    the backward."""
    n = cfg.MODEL.PARAMETERS.NUM_UNROLLS
    return {"llr_normal_pre": n, "llr_normal_post": n - 1}


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


class _RNNTrainer(DSLRTrainer):
    """DSLRTrainer of an `UnrolledLR` with the RNN temporal nets, which no
    config reaches (as in the JAX package)."""

    def build_model(self, generator):
        return build_dslr_solver(self.cfg, generator, use_rnn_temporal=True)


def _serve_dslr(tag, cfg, exam, expected, out_dir=None):
    """The first SERVE_SLICES slices of an exam of the quality set served by
    LRReconstructor on the card (no device given) at ACCEL, one slice per
    call after a warm-up: launches per slice checked against `expected`, ms
    per slice (the median of those calls), one slice's device time by
    group, slice 0 held against the port's CPU path on the same weights.
    With `out_dir` the slices are also written through `reconstruct_exam`
    (the H5 front end's body) and the CFL read back. Returns ({counter:
    launches for the slices}, ms per slice)."""
    cfg.freeze()
    name, kspace, maps, _ = exam
    kspace, maps = kspace[:SERVE_SLICES], maps[:SERVE_SLICES]
    transform = accel_transform(cfg, ACCEL)
    batches = list(batched([transform(kspace[s], maps[s])
                            for s in range(len(kspace))], 1))
    params = init_params(cfg, SEED)
    recon = LRReconstructor(cfg, params)
    check(recon.device.type == "cuda", f"{tag}: LRReconstructor on "
          f"{recon.device}")
    recon(batches[0])                             # warm-up
    torch.cuda.synchronize()
    zero_counts()
    outs, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        outs.append(recon(b))                     # returns host arrays
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    for name_, n in counts.items():
        check(n == expected.get(name_, 0) * len(batches),
              f"{tag}: {n} {name_} launches for {len(batches)} slices, "
              f"expected {expected.get(name_, 0)} per slice and nothing "
              "else")
    out = np.concatenate(outs)
    check(out.shape == (len(kspace), *batches[0]["init_image"].shape[1:])
          and np.isfinite(out).all(), f"{tag}: output {out.shape}")
    ms = float(np.median(times)) * 1e3
    T, Y, X = batches[0]["init_image"].shape[2:]
    print(f"{tag}: {ms:.2f} ms per slice (median of {len(times)} slices of "
          f"{T}x{Y}x{X}, C={kspace.shape[1]}: "
          + ", ".join(f"{t * 1e3:.2f}" for t in times)
          + "), launches per slice "
          + ", ".join(f"{n // len(batches)} {k}" for k, n in counts.items()
                      if n))
    profile_device(f"{tag}: one slice", lambda: recon(batches[0]))
    p = cfg.MODEL.PARAMETERS
    t0 = time.perf_counter()
    decompose_init(batches[0]["init_image"], p.DSLR.BLOCK_SIZE,
                   p.DSLR.NUM_BASIS, overlapping=p.DSLR.OVERLAPPING)
    print(f"{tag}: the host's block SVD of one slice (decompose_init, "
          f"numpy) {(time.perf_counter() - t0) * 1e3:.2f} ms")
    t0 = time.perf_counter()
    cpu = LRReconstructor(cfg, params, device="cpu")(batches[0])
    rel = np.linalg.norm(out[:1] - cpu) / np.linalg.norm(cpu)
    print(f"{tag}: slice 0 vs the port's CPU path "
          f"({time.perf_counter() - t0:.1f} s on the CPU): rel L2 {rel:.3e}")
    check(rel <= CPU_REL_L2_TOL, f"{tag}: GPU vs CPU rel L2 {rel:.3e}")
    if out_dir is not None:
        path = reconstruct_exam(name, kspace, maps, str(out_dir), cfg, recon,
                                ACCEL)
        back = cfl.read(path, order="F")
        want = np.transpose(out, (4, 3, 0, 1, 2))[..., None, None, None]
        check(back.shape == want.shape, f"{tag}: CFL {back.shape} read "
              f"back, the served slices in scanner order {want.shape}")
        rel_cfl = np.linalg.norm(back - want) / np.linalg.norm(want)
        print(f"{tag}: {path} written by reconstruct_exam and read back: "
              f"{list(back.shape)}, rel L2 {rel_cfl:.3e} against the served "
              "slices")
        check(rel_cfl <= CFL_REL_L2_TOL, f"{tag}: CFL rel L2 {rel_cfl:.3e}")
    return counts, ms


def phase_dslr_serve():
    """DSLR serving at the quality set's served slice (cg-v1 and pgd),
    dslr-pgd training, and the RNN temporal nets' train step, at
    config_dslr.yaml's widths."""
    counts = {name: {} for name in COUNTERS}
    exam = quality_split("test", 1)[0]
    shutil.rmtree(RUNS, ignore_errors=True)
    for tag, cfg, expected, out_dir in (
            ("dslr serve cg-v1", dslr_cfg(str(RUNS)), _dslr_launches(
                dslr_cfg())["llr_normal_pre"], RUNS / "serve"),
            ("dslr serve pgd", dslr_pgd_cfg(str(RUNS)), _dslr_pgd_launches(
                dslr_pgd_cfg())["llr_normal_pre"], None)):
        served, _ = _serve_dslr(tag, cfg, exam,
                                {"llr_normal_pre": expected}, out_dir)
        for name, n in served.items():
            counts[name][f"{tag.split()[-1]} served slices"] = n

    # dslr-pgd training through DSLRTrainer, then one step against the CPU
    cfg = dslr_pgd_cfg(str(RUNS))
    trainer = DSLRTrainer(cfg)
    check(trainer.device.type == "cuda", f"DSLRTrainer on {trainer.device}")
    batches = _train_batches("dslr pgd", cfg, trainer, TRAIN_STEPS + 1)
    state = trainer.init_state(state_dict=init_params(cfg, SEED))
    steps = _timed_steps("dslr pgd", trainer, state, batches,
                         _dslr_pgd_launches(cfg), ("Train/complex_l1",))[0]
    for name, c in steps.items():
        counts[name]["pgd train steps"] = c["steps"]
    cut = _cut(cfg, DSLR_CUT_UNROLLS)
    _cpu_step_check("dslr pgd", cut, init_params(cut, SEED), batches[0],
                    DSLRTrainer)

    # the RNN temporal nets (cg-v1), built directly, cut to
    # DSLR_CUT_UNROLLS unrolls: timed steps, one step against the CPU
    cut = _cut(dslr_cfg(str(RUNS)), DSLR_CUT_UNROLLS)
    trainer = _RNNTrainer(cut)
    params = trainer.build_model(
        torch.Generator().manual_seed(SEED)).state_dict()
    state = trainer.init_state(state_dict=params)
    steps = _timed_steps("dslr rnn", trainer, state, batches[:RNN_STEPS + 1],
                         _dslr_launches(cut), ("Train/complex_l1",))[0]
    for name, c in steps.items():
        counts[name]["rnn train steps"] = c["steps"]
    _cpu_step_check("dslr rnn", cut, params, batches[0], _RNNTrainer)

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


def _cpu_step_check(tag, cut, params, batch, trainer_cls=Trainer,
                    loss_tol=TRAIN_LOSS_REL_TOL,
                    grad_tol=TRAIN_GRAD_REL_L2_TOL, frames=None):
    """One train step of the cut config on the card and on the port's CPU
    path from the same weights and batch (its first `frames` frames when
    given), held to the train limits (a bfloat16 trunk's: loss_tol,
    grad_tol)."""
    if frames is not None:      # [B, *, T, Y, X] arrays; maps have no T
        batch = {k: v[:, :, :frames] if np.ndim(v) == 5 else v
                 for k, v in batch.items()}
    gpu = _step_and_grads(cut, params, batch, "cuda", trainer_cls)
    cpu = _step_and_grads(cut, params, batch, "cpu", trainer_cls)
    rel_loss = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    rel_grad = ((gpu[1] - cpu[1]).norm() / cpu[1].norm()).item()
    T = batch["kspace"].shape[2]
    print(f"{tag}: one step at {cut.MODEL.PARAMETERS.NUM_UNROLLS} unroll(s), "
          f"{T} frames, vs the port's CPU path ({cpu[2]:.1f} s on the CPU): "
          f"loss {gpu[0]:.6f} vs {cpu[0]:.6f} (rel {rel_loss:.3e}), gradient "
          f"rel L2 {rel_grad:.3e} over {cpu[1].numel()} values")
    check(rel_loss <= loss_tol,
          f"{tag} GPU vs CPU train loss rel {rel_loss:.3e}")
    check(rel_grad <= grad_tol,
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


def _diffusion_params(cfg):
    """The solver's seeded torch-default init plus seeded noise of scale
    DIFF_WEIGHT_NOISE on every tensor: the adaLN, FiLM and final layers are
    zero at init, and a zero-output network would check nothing."""
    g = torch.Generator().manual_seed(SEED + 1)
    return {k: v + DIFF_WEIGHT_NOISE * torch.randn(v.shape, generator=g)
            for k, v in init_params(cfg, SEED).items()}


def _cpu_randn(seed, device):
    """A randn(shape, dtype) drawing from a CPU generator, moved to
    `device`: the same noise on the card and on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return lambda shape, dtype: torch.randn(shape, dtype=dtype,
                                            generator=g).to(device)


def _diffusion_cfg(model, dtype="float32"):
    cfg = quality_cfg(dtype, model)
    cfg.OUTPUT_DIR = str(RUNS)
    cfg.freeze()
    return cfg


def _swindiff_cfg():
    """A SwinDiff solver at latte2.yaml's geometry and rule, its trunk cut
    to SWINDIFF_LAYERS layers: 96 features (SwinDiffNet's own width), 4
    heads of 24."""
    cfg = quality_cfg(model="latte2")
    cfg.MODEL.MODEL_TYPE = "SWIN_DIFF"
    cfg.OUTPUT_DIR = str(RUNS)
    p = cfg.MODEL.PARAMETERS
    p.NUM_SWINBLOCKS, p.NUM_LAYERS = 1, SWINDIFF_LAYERS
    p.NUM_FEATURES, p.NUM_HEADS = 96, 4
    cfg.freeze()
    return cfg


def _serve_diffusion(tag, cfg, params, examples, steps, expected, counts,
                     batch_sizes=(1, 4), cpu_tol=CPU_REL_L2_TOL):
    """DiffusionReconstructor on the card over `examples` at `steps`
    sampling steps and each batch size: launches per batch checked against
    `expected` (per sampling step), ms per slice, peak memory; slice 0 at 2
    steps held against the CPU path with the same noise (to cpu_tol)."""
    E, T, Y, X = examples[0]["init_image"].shape
    recon = DiffusionReconstructor(cfg, params, sample_steps=steps)
    check(recon.device.type == "cuda", f"{tag} on {recon.device}")
    torch.cuda.reset_peak_memory_stats()
    out = None
    for bs in batch_sizes:
        zero_counts()
        got, sec = _time_recon(recon, examples, bs, repeats=1)
        nbatch = -(-len(examples) // bs)
        for name, n in read_counts().items():
            counts[name][f"{tag} serve batch {bs}"] = n
            want = expected.get(name, 0) * steps * nbatch
            check(n == want, f"{tag} batch {bs}: {n} {name} launches, "
                  f"expected {want}")
        check(got.shape == (len(examples), E, T, Y, X)
              and np.isfinite(got).all(), f"{tag} output {got.shape}")
        out = got if out is None else out
        print(f"{tag} serve batch {bs}: {sec / len(examples) * 1e3:.2f} ms "
              f"per slice at {steps} sampling steps "
              f"({sec / len(examples) / steps * 1e3:.3f} ms per step)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag}: peak device memory {peak_gb:.2f} GB")

    batch = next(batched(examples[:1], 1))
    short = DiffusionReconstructor(cfg, params, sample_steps=2)
    profile_device(f"{tag}: one slice, 2 sampling steps", lambda: short(batch))
    short.randn = _cpu_randn(SEED, recon.device)
    gpu = short(batch)
    cpu_recon = DiffusionReconstructor(cfg, params, sample_steps=2,
                                       device="cpu",
                                       randn=_cpu_randn(SEED, "cpu"))
    t0 = time.perf_counter()
    cpu = cpu_recon(batch)
    rel = np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu)
    print(f"{tag}: slice 0 at 2 sampling steps vs the port's CPU path "
          f"({time.perf_counter() - t0:.1f} s on the CPU), the same noise: "
          f"rel L2 {rel:.3e}")
    check(rel <= cpu_tol, f"{tag} GPU vs CPU rel L2 {rel:.3e}")
    return out


def _with_gradient(name, p):
    """The elements of a parameter that take a gradient: the key third of an
    attention's qkv bias takes none in exact arithmetic (a constant added to
    a query's logits leaves its softmax as it is), so its gradient is
    roundoff, which Adam scales up."""
    keep = torch.ones(p.shape, dtype=torch.bool)
    if name.endswith("attn.qkv.bias"):
        n = p.shape[0] // 3
        keep[n:2 * n] = False
    return keep


def _diffusion_step(cfg, params, batch, device, t, noise):
    """(loss, flat gradient, flat change of the EMA, how far that change is
    from (1 - decay) times the parameters' change (rel L2), seconds) of one
    DiffusionTrainer step from `params` at the given t and noise, with an
    EMA of decay DIFF_CHECK_EMA_DECAY; the changes over the elements that
    take a gradient."""
    trainer = DiffusionTrainer(cfg, device=device,
                               ema_decay=DIFF_CHECK_EMA_DECAY)
    state = trainer.init_state(state_dict=params)
    t0 = time.perf_counter()
    loss = float(trainer.train_step(state, batch, t=t,
                                    noise=noise)["Train MSE"])
    seconds = time.perf_counter() - t0
    grads, moved, stepped = [], [], []
    for name, p in state.model.named_parameters():
        if p.grad is None:
            continue
        grads.append(p.grad.flatten().cpu())
        keep = _with_gradient(name, p)
        moved.append((state.ema[name].cpu() - params[name])[keep])
        stepped.append((p.detach().cpu() - params[name])[keep])
    moved, stepped = torch.cat(moved), torch.cat(stepped)
    rule = ((moved - (1 - DIFF_CHECK_EMA_DECAY) * stepped).norm()
            / moved.norm()).item()
    return loss, torch.cat(grads), moved, rule, seconds


def _draws_ab(tag, trainer, state, batches, busy_ms):
    """ms per train step with t and noise drawn on the card (the trainer's
    own draws) and drawn on the host from a CPU generator and copied in
    (given to train_step), in DIFF_DRAW_ROUNDS alternating rounds over
    `batches`; the device's busy ms of a profiled step over each median."""
    host = DiffusionTrainer(trainer.cfg, device="cpu")
    times = {"card": [], "host": []}
    for r in range(DIFF_DRAW_ROUNDS):
        for mode in ("card", "host") if r % 2 == 0 else ("host", "card"):
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                draws = ({} if mode == "card" else dict(zip(
                    ("t", "noise"),
                    host.draws(SEED + 7, state.step, b["target"]))))
                trainer.train_step(state, b, **draws)
                torch.cuda.synchronize()
                times[mode].append(time.perf_counter() - t0)
    ms = {mode: float(np.median(v)) * 1e3 for mode, v in times.items()}
    print(f"{tag}: t and noise drawn on the card {ms['card']:.2f} ms per "
          f"step, on the host and copied in {ms['host']:.2f} ms (medians "
          f"of {len(times['card'])} steps each, alternating rounds); the "
          f"profiled step's device {busy_ms:.2f} ms is "
          f"{busy_ms / ms['card']:.1%} and {busy_ms / ms['host']:.1%} of "
          "them")
    return ms


class _AttentionRecorder:
    """Within `with`: the inputs (q, k, v, bias, mask) of the first
    unshifted and the first shifted window-attention call of the Swin
    blocks, by `masked`, copied."""

    def __enter__(self):
        self.seen = {}
        self.real = swin_module.window_attention

        def record(q, k, v, bias, mask=None):
            self.seen.setdefault(mask is not None, tuple(
                None if x is None else x.detach().clone()
                for x in (q, k, v, bias, mask)))
            return self.real(q, k, v, bias, mask)

        swin_module.window_attention = record
        return self

    def __exit__(self, *exc):
        swin_module.window_attention = self.real


def _diffusion_train(tag, cfg, params, files, steps, expected, counts,
                     cpu_check=False, ema_vs_cpu=False, draws_ab=False,
                     loss_tol=TRAIN_LOSS_REL_TOL,
                     grad_tol=TRAIN_GRAD_REL_L2_TOL):
    """DiffusionTrainer on the card fed by the device pipeline (diffusion
    batches): 1 warm-up and `steps` timed steps, launches per step against
    `expected`, one profiled step; with `draws_ab` the step with t and noise
    drawn on the card against drawn on the host; with `cpu_check` one step
    against the CPU: the loss, the gradient, the EMA's change against its
    rule on each device, with `ema_vs_cpu` also against the CPU's change.
    Adam's first step is about lr * sign(g), so the parameters' change, and
    the EMA's, amplify the gradient's roundoff where g is near 0: hold them
    to the CPU's only where the gradients agree far below the limit. A
    bfloat16 trunk's loss and gradient are held to loss_tol and grad_tol."""
    trainer = DiffusionTrainer(cfg)                 # the GPU: no device given
    check(trainer.device.type == "cuda", f"{tag} trainer on {trainer.device}")
    loader = trainer._train_loader(None, files)
    check(isinstance(loader, DevicePipelineLoader) and loader.pipe.diffusion,
          f"{tag}: not fed by the device pipeline's diffusion batches")
    trainer.set_steps_per_epoch(len(loader))
    batches = []
    while len(batches) < steps + 1:
        batches.extend(loader)
    batches = batches[:steps + 1]
    check("kspace" not in batches[0] and batches[0]["mask_r"].is_cuda,
          f"{tag}: pipeline batch keys {sorted(batches[0])}")
    state = trainer.init_state(state_dict=params)
    trained, ms, _, (groups, busy) = _timed_steps(
        tag, trainer, state, batches, expected, ("Train MSE",))
    for name, c in trained.items():
        counts[name][f"{tag} steps"] = c["steps"]
    if draws_ab:
        _draws_ab(tag, trainer, state, batches[1:], busy)
    del trainer, state
    torch.cuda.empty_cache()
    attention = {}
    if cpu_check:
        # the same t and noise on both devices, drawn on the CPU
        t, noise = DiffusionTrainer(cfg, device="cpu").draws(
            SEED + 7, 0, batches[0]["target"])
        with _AttentionRecorder() as recorder:
            gpu = _diffusion_step(cfg, params, batches[0],
                                  batches[0]["maps"].device, t, noise)
        cpu = _diffusion_step(cfg, params, batches[0], "cpu", t, noise)
        rel_loss = abs(gpu[0] - cpu[0]) / abs(cpu[0])
        rel_grad = ((gpu[1] - cpu[1]).norm() / cpu[1].norm()).item()
        rel_ema = ((gpu[2] - cpu[2]).norm() / cpu[2].norm()).item()
        print(f"{tag}: one step vs the port's CPU path ({cpu[4]:.1f} s on "
              f"the CPU), the same t and noise: loss {gpu[0]:.6f} vs "
              f"{cpu[0]:.6f} (rel {rel_loss:.3e}), gradient rel L2 "
              f"{rel_grad:.3e} over {cpu[1].numel()} values; EMA (decay "
              f"{DIFF_CHECK_EMA_DECAY}) change over {cpu[2].numel()} values "
              f"(norm {cpu[2].norm():.3e}): from its rule rel L2 "
              f"{gpu[3]:.3e} on the card, {cpu[3]:.3e} on the CPU; against "
              f"the CPU's rel L2 {rel_ema:.3e}"
              + ("" if ema_vs_cpu else " (not held: Adam's first step)"))
        check(rel_loss <= loss_tol,
              f"{tag} GPU vs CPU loss rel {rel_loss:.3e}")
        check(rel_grad <= grad_tol,
              f"{tag} GPU vs CPU gradient rel L2 {rel_grad:.3e}")
        check(gpu[2].norm() > 0 and cpu[2].norm() > 0
              and max(gpu[3], cpu[3]) <= TRAIN_GRAD_REL_L2_TOL,
              f"{tag}: the EMA's change from its rule {gpu[3]:.3e} on the "
              f"card, {cpu[3]:.3e} on the CPU")
        check(not ema_vs_cpu or rel_ema <= TRAIN_GRAD_REL_L2_TOL,
              f"{tag} GPU vs CPU EMA change rel L2 {rel_ema:.3e}")
        for masked, inputs in sorted(recorder.seen.items()):
            attention[tag, masked] = kernels_attention_at(tag, masked,
                                                          *inputs)
    return ms, busy, attention


def phase_diffusion():
    """The diffusion paths on the card: Latte-2u serving and training, a
    DiT train step and sampling run, SwinDiff serving and training (the
    one diffusion path with window attention)."""
    counts = {name: {} for name in COUNTERS}
    T, Y, X, C, E = headline_shape()
    slices = [make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=SEED + s)
              for s in range(SLICES)]
    none = {name: 0 for name in COUNTERS}

    latte = _diffusion_cfg("latte2")
    params = _diffusion_params(latte)
    examples = [ResampleTransform(ACCEL, latte)(k, m) for k, m, _ in slices]
    print(f"diffusion: Latte-2u (latte2.yaml widths, "
          f"{sum(v.numel() for v in params.values()) / 1e6:.2f}M params) on "
          f"{SLICES} slices [{C},{T},{Y},{X}] E={E} at {ACCEL}x")
    _serve_diffusion("latte", latte, params, examples, DIFF_SAMPLE_STEPS,
                     none, counts)

    t0 = time.perf_counter()
    files = quality_split("train", 1)
    print(f"diffusion: 1 quality-set train file ({len(files[0][1])} slices) "
          f"made in {time.perf_counter() - t0:.1f} s")
    _diffusion_train("latte train", latte, params, files, DIFF_TRAIN_STEPS,
                     none, counts, cpu_check=True, ema_vs_cpu=True,
                     draws_ab=True)

    dit = _diffusion_cfg("dit")
    dit_params = _diffusion_params(dit)
    _diffusion_train("dit train", dit, dit_params, files, 1, none, counts)
    _serve_diffusion("dit", dit, dit_params, examples[:1], DIFF_SHORT_STEPS,
                     none, counts, batch_sizes=(1,))

    swd = _swindiff_cfg()
    p = swd.MODEL.PARAMETERS
    per_net = p.NUM_SWINBLOCKS * p.NUM_LAYERS
    swd_params = _diffusion_params(swd)
    _serve_diffusion("swindiff", swd, swd_params, examples,
                     DIFF_SHORT_STEPS,
                     {**none, "window_attention": p.NUM_UNROLLS * per_net},
                     counts, batch_sizes=(4,))
    _, _, attention = _diffusion_train(
        "swindiff train", swd, swd_params, files, 1,
        {**none, "window_attention": p.NUM_UNROLLS * per_net,
         "window_attention_bwd": p.NUM_UNROLLS * per_net},
        counts, cpu_check=True)
    check(sorted(key[1] for key in attention) == [False, True],
          f"swindiff train: window-attention inputs seen {sorted(attention)}")
    shutil.rmtree(RUNS, ignore_errors=True)
    return counts, attention


def phase_swin_bf16():
    """config_swin.yaml with a bfloat16 trunk on the card: served like the
    swin phase (bf16 q, k, v through the window-attention kernels);
    Trainer steps at batch 1 with the launches of the float32 path; one
    step at 1 unroll on the first SWIN_BF16_CPU_FRAMES frames against the
    CPU, which checks the forward as well (the script's time limit leaves
    no room for a CPU comparison of the serving path too)."""
    counts = {name: {} for name in COUNTERS}
    cfg = swin_cfg()
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "bfloat16"
    p = cfg.MODEL.PARAMETERS
    served = run_path("swin_bf16", cfg, {
        "sense_normal": p.NUM_UNROLLS,
        "window_attention": 6 * p.NUM_SWINBLOCKS * p.NUM_UNROLLS,
        "window_attention_bwd": 0}, batch_tol=BF16_REL_L2_TOL,
        cpu_check=False)[0]
    for name, by_bs in served.items():
        for bs, n in by_bs.items():
            counts[name][f"serve batch {bs}"] = n

    train_cfg = swin_cfg(output_dir=str(RUNS))
    train_cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "bfloat16"
    train_cfg.freeze()
    trainer = Trainer(train_cfg)                # the GPU: no device given
    check(trainer.device.type == "cuda", f"Trainer on {trainer.device}")
    batches = _train_batches("swin_bf16 train", train_cfg, trainer,
                             SWIN_BF16_TRAIN_STEPS + 1)
    state = trainer.init_state(state_dict=init_params(train_cfg, SEED))
    check(state.model.nets[0].trunks[0].dtype == torch.bfloat16
          and all(q.dtype == torch.float32 for q in state.model.parameters()),
          "swin_bf16: trunk dtype or parameter dtypes")
    trained = _timed_steps("swin_bf16 train", trainer, state, batches,
                           _train_launches(train_cfg),
                           ("Train/complex_l1",))[0]
    for name, c in trained.items():
        counts[name]["train steps"] = c["steps"]
    del trainer, state
    torch.cuda.empty_cache()
    cut = _cut(train_cfg, 1)
    _cpu_step_check("swin_bf16 train", cut, init_params(cut, SEED),
                    batches[0], loss_tol=BF16_TRUNK_LOSS_REL_TOL,
                    grad_tol=BF16_TRUNK_GRAD_REL_L2_TOL,
                    frames=SWIN_BF16_CPU_FRAMES)
    shutil.rmtree(RUNS, ignore_errors=True)
    return counts


def phase_diffusion_bf16():
    """configs/quality/dit_bf16.yaml's DiT trained through the device
    pipeline and sampled for DIFF_SHORT_STEPS steps; Latte at latte2.yaml's
    widths in bfloat16, its steps timed and one against the CPU. No kernel of the
    port runs on these paths (their attention is plain matmuls, as in the
    JAX package)."""
    counts = {name: {} for name in COUNTERS}
    none = {name: 0 for name in COUNTERS}
    T, Y, X, C, E = headline_shape()
    example = ResampleTransform(ACCEL, headline_cfg())(*make_cine_example(
        T=T, Y=Y, X=X, C=C, E=E, seed=SEED)[:2])
    files = quality_split("train", 1)

    dit = _diffusion_cfg("dit", "bfloat16")
    check(dit.MODEL.PARAMETERS.CONV_BLOCK.DTYPE == "bfloat16",
          "diffusion_bf16: dit_bf16's dtype")
    params = _diffusion_params(dit)
    _diffusion_train("dit_bf16 train", dit, params, files, DIFF_BF16_STEPS,
                     none, counts)
    _serve_diffusion("dit_bf16", dit, params, [example], DIFF_SHORT_STEPS,
                     none, counts, batch_sizes=(1,), cpu_tol=BF16_REL_L2_TOL)

    latte = _diffusion_cfg("latte2", "bfloat16")
    _diffusion_train("latte_bf16 train", latte, _diffusion_params(latte),
                     files, DIFF_BF16_STEPS, none, counts, cpu_check=True,
                     loss_tol=BF16_TRUNK_LOSS_REL_TOL,
                     grad_tol=BF16_TRUNK_GRAD_REL_L2_TOL)
    shutil.rmtree(RUNS, ignore_errors=True)
    return counts


def _mg_batch(cfg, n, seed=SEED):
    """n full-width slices through the config's preprocess, stacked: a
    global batch of n."""
    T, Y, X, C, E = headline_shape()
    raw_x = RAW_X if cfg.AUG_TRAIN.CROP_READOUT else X
    pre = CinePreprocess(cfg, use_seed=True)
    examples = [pre(*make_cine_example(T=T, Y=Y, X=raw_x, C=C, E=E,
                                       seed=seed + s), f"multigpu_{s}")
                for s in range(n)]
    return {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}


def _mg_steps(trainer, params, batch, expected, key="Train/complex_l1",
              profile=None):
    """One step from `params` (its loss and its gradients gathered whole,
    flat on the CPU, in the unsplit qkv order), then MG_STEPS timed steps
    on the same batch with their launches checked against `expected` per
    step; with a `profile` label, one more step profiled on rank 0 (the
    other ranks run it plainly). Returns (loss, gradient, median ms per
    step, {counter: launches}, the names of the modules under the
    tensor-parallel plan, the profile's (groups, busy ms) or None)."""
    state = trainer.init_state(state_dict=params)
    loss = float(trainer.train_step(state, batch)[key])
    grads = unpermute_qkv(state.model, _whole_grads(state.model))
    torch.cuda.synchronize()
    zero_counts()
    times = []
    for _ in range(MG_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    for name, n in counts.items():
        check(n == expected.get(name, 0) * MG_STEPS,
              f"multigpu: {n} {name} launches in {MG_STEPS} steps, expected "
              f"{expected.get(name, 0)} per step")
    prof = None
    if profile is not None:
        def step():
            trainer.train_step(state, batch)
        if (not torch.distributed.is_initialized()
                or torch.distributed.get_rank() == 0):
            prof = profile_device(profile, step)
        else:
            step()
    flat = torch.cat([grads[n].flatten() for n in sorted(grads)])
    return (loss, flat, float(np.median(times)) * 1e3, counts,
            getattr(state.model, "tp_modules", []), prof)


def _whole_grads(model):
    """Every parameter's gradient whole, float32 on the CPU. A DTensor's
    local shards are exchanged as objects, through the CPU (DTensor's own
    gather, all_gather_into_tensor, crashed under gloo on CUDA tensors),
    and joined along the mesh axis that splits them (one in these
    meshes)."""
    from torch.distributed.tensor import DTensor

    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    local = {n: (g.to_local() if isinstance(g, DTensor) else g
                 ).detach().float().cpu() for n, g in grads.items()}
    if not torch.distributed.is_initialized():
        return local
    parts = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(parts, local)
    out = {}
    for n, g in grads.items():
        split = [(i, pl.dim) for i, pl in enumerate(getattr(g, "placements",
                                                            ()))
                 if pl.is_shard() and g.device_mesh.size(i) > 1]
        if not split:
            out[n] = local[n]
            continue
        check(len(split) == 1, f"multigpu: {n} split over {split}")
        (axis, dim), = split
        ranks = g.device_mesh.mesh
        for i, c in enumerate(g.device_mesh.get_coordinate()):
            if i != axis:
                ranks = ranks.select(0 if i < axis else 1, c)
        out[n] = torch.cat([parts[int(r)][n] for r in ranks], dim)
    return out


def _mg_example_cfg(strategy="standard", unrolls=None):
    cfg = headline_cfg(output_dir=str(RUNS))
    cfg.MODEL.STRATEGY = strategy
    if unrolls:
        cfg.MODEL.PARAMETERS.NUM_UNROLLS = unrolls
    return cfg


def _mg_swin_cfg():
    """The bf16 Swin at config_swin's widths, its depth cut to
    MG_GLOO_UNROLLS."""
    cfg = swin_cfg(output_dir=str(RUNS))
    cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE = "bfloat16"
    cfg.MODEL.PARAMETERS.NUM_UNROLLS = MG_GLOO_UNROLLS
    return cfg


def _mg_sense(cfg):
    """SENSE launches per train step of an unrolled config."""
    return {"sense_normal": 2 * cfg.MODEL.PARAMETERS.NUM_UNROLLS - 1}


def _mg_attention_inputs(W):
    """q, k, v and bias of W windows, and the shift mask, at config_swin's
    block shapes (12 windows a frame batch)."""
    N = SWIN_WINDOW[0] * SWIN_WINDOW[1] * SWIN_WINDOW[2]
    mask = torch.from_numpy(compute_shift_mask(
        *SWIN_GRID, SWIN_WINDOW, SWIN_SHIFT)).cuda()
    rng = np.random.RandomState(SEED + 5)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (W, SWIN_HEADS, N, SWIN_HEAD_DIM)).astype(np.float32)).cuda()
        for _ in range(3))
    bias = torch.from_numpy(0.5 * rng.standard_normal(
        (SWIN_HEADS, N, N)).astype(np.float32)).cuda()
    return q, k, v, bias, mask


def _nccl_rank(rank, device, world, params, batch, examples):
    """One NCCL rank a card (every rank runs it; rank 0's results are
    returned): (a) the example config under HSDP and under STRATEGY fsdp,
    one slice a rank; (c) data-parallel serving at B=4 against the plain
    Reconstructor; (e) the dry run's rank body (`entry.dryrun_multichip`
    spawns its ranks with the same `run_ranks` and runs `dryrun_rank` on
    them; here it runs on these ranks, which saves a second spawn). The
    weights, the global batch and the served examples come from the
    caller. Seconds of each part in "seconds"."""
    use_ieee_fp32()
    t0 = time.perf_counter()
    out, launches, seconds = {}, {name: {} for name in COUNTERS}, {}
    cfg = _mg_example_cfg()
    hsdp = Trainer(cfg, device=device, mesh=make_mesh(data=world))
    fsdp = Trainer(_mg_example_cfg("fsdp"), device=device)
    check(tuple(fsdp.mesh.shape) == (1, world, 1),
          f"multigpu: STRATEGY fsdp mesh {tuple(fsdp.mesh.shape)}")
    for tag, trainer in (("hsdp", hsdp), ("fsdp", fsdp)):
        out[tag] = _mg_steps(trainer, params, batch, _mg_sense(cfg))
        for name, n in out[tag][3].items():
            launches[name][f"{tag} train steps"] = n
    del hsdp, fsdp
    seconds["a"], t0 = time.perf_counter() - t0, time.perf_counter()

    plain = Reconstructor(cfg, params, device=device)(examples)
    zero_counts()
    t1 = time.perf_counter()
    dp = Reconstructor(cfg, params, device=device,
                       mesh=make_mesh())(examples)
    out["recon_ms"] = (time.perf_counter() - t1) * 1e3
    for name, n in read_counts().items():
        launches[name]["data-parallel serve B=4"] = n
    out["recon"] = (float(np.linalg.norm(dp - plain) / np.linalg.norm(plain)),
                    dp.shape)
    seconds["c"], t0 = time.perf_counter() - t0, time.perf_counter()

    zero_counts()
    out["dryrun"] = dryrun_rank(rank, device, world)
    for name, n in read_counts().items():
        launches[name]["dry run steps"] = n
    seconds["e"] = time.perf_counter() - t0
    out["launches"], out["seconds"] = launches, seconds
    return out if rank == 0 else None


def _gloo_rank(rank, device, go, example, swin):
    """Two gloo ranks with CUDA tensors sharing card 0 (gloo takes CUDA
    tensors for all-reduce, the one collective that data parallelism over
    `data`, the tensor-parallel plan and the sharded attention need; its
    reduce-scatter on them crashed the process in a development run, so
    fsdp > 1 needs NCCL and a card a rank). `example` and `swin` are the
    (weights, global batch) of the example config and the bf16 Swin, both
    cut to MG_GLOO_UNROLLS unrolls. (f) the example config under HSDP over
    data=2; (b) the bf16 Swin step under the tensor-parallel plan
    at model=2 (H/2 heads a rank, qkv reordered, the bias table's columns
    of the rank's heads), one step profiled on rank 0; (d)
    `window_attention_sharded` at n=2 against the unsharded kernel on the
    rank's windows, the shift mask shared (24 windows) and sliced per
    window (12), and no mask. The rank waits for `go` (set once the card
    is free) before it starts. Rank 0's results, seconds of each part in
    "seconds"."""
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    use_ieee_fp32()
    cfg, scfg = _mg_example_cfg(unrolls=MG_GLOO_UNROLLS), _mg_swin_cfg()
    out, launches, seconds = {}, {name: {} for name in COUNTERS}, {}
    go.wait()
    t0 = time.perf_counter()

    trainer = Trainer(cfg, device=card,
                      mesh=make_mesh(data=2, device_type="cuda"))
    out["gloo"] = _mg_steps(trainer, *example, _mg_sense(cfg))
    del trainer
    seconds["f"], t0 = time.perf_counter() - t0, time.perf_counter()

    trainer = Trainer(scfg, device=card,
                      mesh=make_mesh(1, 1, 2, device_type="cuda"))
    out["tp"] = _mg_steps(trainer, *swin, _train_launches(scfg),
                          profile="multigpu bf16 Swin, tensor-parallel "
                                  "model=2 (rank 0)")
    del trainer
    seconds["b"], t0 = time.perf_counter() - t0, time.perf_counter()

    wmesh = make_mesh(data=2, device_type="cuda")
    out["attention"] = {}
    for W, masked in ((24, True), (12, True), (24, False)):
        q, k, v, bias, mask = _mg_attention_inputs(W)
        mk = mask if masked else None
        zero_counts()
        local = WA.window_attention_sharded(q, k, v, bias, mk, wmesh)
        n = read_counts()["window_attention"]
        m = W // 2
        whole = WA.window_attention(q, k, v, bias, mk)[rank * m:(rank + 1) * m]
        torch.cuda.synchronize()
        tag = (f"W={W} " + ("mask shared" if masked and m % mask.shape[0] == 0
                            else "mask sliced" if masked else "no mask"))
        out["attention"][tag] = (float((local - whole).abs().max()), n)
        launches["window_attention"][f"sharded n=2 {tag}"] = n
    seconds["d"] = time.perf_counter() - t0
    for tag in ("gloo", "tp"):
        for name, n in out[tag][3].items():
            launches[name][{"gloo": "gloo 2-rank HSDP train steps",
                            "tp": "gloo 2-rank TP train steps"}[tag]] = n
    out["launches"], out["seconds"] = launches, seconds
    return out if rank == 0 else None


def phase_multigpu():
    """The mesh on the card. The unwrapped references first, in this
    process before it joins a process group (a Trainer on a process group
    takes the mesh of its config); then world = every card NCCL ranks, one
    card each, rank 0 in this process and the others spawned (the kernels
    are built, by phase_build, before any rank starts); then two spawned
    gloo ranks sharing card 0, for what needs more ranks than the machine
    has cards: they are spawned first with their inputs, and start up
    while this process has the card, then wait for it. Each wrapped step
    is held against the unwrapped Trainer step on card 0, from the same
    weights and global batch."""
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    cfg, cut, scfg = (_mg_example_cfg(), _mg_example_cfg(
        unrolls=MG_GLOO_UNROLLS), _mg_swin_cfg())
    params, batch = init_params(cfg, SEED), _mg_batch(cfg, world)
    example = (init_params(cut, SEED), _mg_batch(cfg, 2))
    swin = (init_params(scfg, SEED), _mg_batch(scfg, 1))
    examples = _mg_batch(cfg, 4, seed=SEED + 10)
    go = torch.multiprocessing.get_context("spawn").Event()
    with ThreadPoolExecutor(1) as pool:
        gloo = pool.submit(run_ranks, _gloo_rank, 2, "gloo", go, example,
                           swin, threads=None)
        try:
            refs = {"nccl": _mg_steps(Trainer(cfg, device="cuda"), params,
                                      batch, _mg_sense(cfg)),
                    "gloo": _mg_steps(Trainer(cut, device="cuda"), *example,
                                      _mg_sense(cut)),
                    "tp": _mg_steps(Trainer(scfg, device="cuda"), *swin,
                                    _train_launches(scfg),
                                    profile="multigpu bf16 Swin, unwrapped")}
            t1 = time.perf_counter()
            res = run_ranks(_nccl_rank, world, "nccl", world, params, batch,
                            examples, threads=None, rank0_here=True)[0]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        finally:
            go.set()
        t2 = time.perf_counter()
        gloo = gloo.result()[0]
    t3 = time.perf_counter()
    print(f"multigpu: the inputs and the unwrapped references {t1 - t0:.1f} "
          f"s; {world} NCCL "
          f"rank(s), one card each, rank 0 in this process, {t2 - t1:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in res["seconds"].items())
          + f"); 2 spawned gloo ranks on card 0, {t3 - t2:.1f} s after "
          "the card was theirs ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in gloo["seconds"].items())
          + ")")
    launches = res["launches"]
    for name, by_path in gloo["launches"].items():
        launches[name].update(by_path)
    f32 = (TRAIN_LOSS_REL_TOL, TRAIN_GRAD_REL_L2_TOL)
    bf16 = (BF16_TRUNK_LOSS_REL_TOL, BF16_TRUNK_GRAD_REL_L2_TOL)
    for tag, r, ref, tol, what in (
            ("hsdp", res, refs["nccl"], f32,
             f"example config, HSDP over data={world} (NCCL)"),
            ("fsdp", res, refs["nccl"], f32,
             f"example config, STRATEGY fsdp (fsdp={world}, NCCL)"),
            ("gloo", gloo, refs["gloo"], f32,
             f"example config at {MG_GLOO_UNROLLS} unrolls, HSDP over data=2: "
             "2 gloo ranks sharing card 0 (against the unwrapped B=2 step)"),
            ("tp", gloo, refs["tp"], bf16,
             f"bf16 Swin at {MG_GLOO_UNROLLS} unrolls, tensor-parallel "
             "model=2: 2 gloo ranks sharing card 0")):
        loss, grad, ms, counts = r[tag][:4]
        rel_loss = abs(loss - ref[0]) / abs(ref[0])
        rel_grad = float((grad - ref[1]).norm() / ref[1].norm())
        print(f"multigpu {tag}: {what}: {ms:.2f} ms per step wrapped vs "
              f"{ref[2]:.2f} unwrapped (median of {MG_STEPS}); loss "
              f"{loss:.6f} vs {ref[0]:.6f} (rel {rel_loss:.3e}), gradient rel "
              f"L2 {rel_grad:.3e}; launches per step "
              + ", ".join(f"{n // MG_STEPS} {k}" for k, n in counts.items()
                          if n))
        check(rel_loss <= tol[0], f"multigpu {tag}: loss rel {rel_loss:.3e}")
        check(rel_grad <= tol[1], f"multigpu {tag}: gradient rel L2 "
              f"{rel_grad:.3e}")
    tp_modules = len(gloo["tp"][4])
    check(tp_modules == 12 * scfg.MODEL.PARAMETERS.NUM_UNROLLS,
          f"multigpu tp: {tp_modules} modules under the plan, expected 6 "
          "attentions and 6 MLPs a trunk")
    check(gloo["tp"][3]["window_attention"] > 0
          and gloo["tp"][3]["window_attention_bwd"] > 0,
          "multigpu tp: the attention kernels did not run on the local heads")
    rel, shape = res["recon"]
    print(f"multigpu recon: data-parallel Reconstructor at B=4 over "
          f"{world} NCCL rank(s) vs the plain one: rel L2 {rel:.3e}, "
          f"{res['recon_ms']:.1f} ms, output {shape}")
    check(rel <= MG_RECON_REL_TOL and shape[0] == 4,
          f"multigpu recon rel L2 {rel:.3e}")
    for tag, (err, n) in gloo["attention"].items():
        print(f"multigpu attention: window_attention_sharded n=2, {tag}, "
              f"vs the unsharded kernel on rank 0's windows: max abs err "
              f"{err:.3e}, {n} launch")
        check(err <= MG_ATTENTION_ABS_TOL and n == 1,
              f"multigpu attention {tag}: err {err:.3e}, {n} launches")
    check(len(gloo["attention"]) == 3, "multigpu attention: a mask branch "
          f"missing from {list(gloo['attention'])}")
    losses = res["dryrun"]
    dry = {n: c["dry run steps"] for n, c in launches.items()}
    print("multigpu dryrun: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in losses.items())
          + "; launches " + ", ".join(f"{n} {k}" for k, n in dry.items()))
    check(len(losses) >= 4 and all(np.isfinite(v) for v in losses.values()),
          f"dryrun {losses}")
    check(dry["sense_normal"] > 0 and dry["llr_normal_pre"] > 0,
          f"dryrun launches {dry}: the unrolled and DSLR steps launch the "
          "SENSE and LLR kernels")
    shutil.rmtree(RUNS, ignore_errors=True)
    return launches


class _VDktPaths:
    """Counts the VDkt masks drawn on the native and on the Python path
    while it is entered (ops/masks.py calls its module's
    `vdkt_mask_native`, which returns None where the Python path runs)."""

    def __enter__(self):
        self.native = self.python = 0
        self._saved = masks_module.vdkt_mask_native
        masks_module.vdkt_mask_native = self
        return self

    def __call__(self, *args):
        out = self._saved(*args)
        if out is None:
            self.python += 1
        else:
            self.native += 1
        return out

    def __exit__(self, *exc):
        masks_module.vdkt_mask_native = self._saved


def _host_ms(fn, runs):
    """Median host ms of fn() over `runs` calls."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def compact_vdkt():
    """(a) The native library is built and loaded, and each case's mask
    equals the Python path's bit for bit."""
    lib = native.get_vdkt_lib()
    check(lib is not None, "native VDkt: no library, the Python path would "
          "be taken")
    print(f"compact vdkt: native library {native.library_path()}")
    for tag, shape, accel, pkx, pky, seed in COMPACT_VDKT_CASES:
        func = VDktMaskFunc(accel, sim_partial_kx=pkx, sim_partial_ky=pky)
        with _VDktPaths() as paths:
            nat = func(shape, seed=seed)
            nat_ms = _host_ms(lambda: func(shape, seed=seed),
                              COMPACT_VDKT_RUNS)
        check(paths.python == 0 and paths.native > 0,
              f"compact vdkt {tag}: the Python path was taken")
        saved = masks_module.vdkt_mask_native
        masks_module.vdkt_mask_native = lambda *a: None
        try:
            py = func(shape, seed=seed)
            py_ms = _host_ms(lambda: func(shape, seed=seed),
                             COMPACT_VDKT_RUNS)
        finally:
            masks_module.vdkt_mask_native = saved
        same = nat.dtype == py.dtype and np.array_equal(nat, py)
        print(f"compact vdkt {tag}: native {nat_ms:.3f} ms, Python "
              f"{py_ms:.3f} ms a mask (host, median of {COMPACT_VDKT_RUNS}); "
              f"bit for bit {same}, {int(nat.sum())} samples")
        check(same, f"compact vdkt {tag}: native and Python masks differ")


def _violation(out, ref, rtol, atol):
    """The largest excess of |out - ref| over atol + rtol |ref| (<= 0
    where np.allclose holds)."""
    return float((np.abs(out - ref) - (atol + rtol * np.abs(ref))).max())


def compact_serving(counts):
    """(b) Main's slices over the three wires against the dense path."""
    cfg = headline_cfg()
    cfg.freeze()
    nunroll = cfg.MODEL.PARAMETERS.NUM_UNROLLS
    T, Y, X, C, E = headline_shape()
    slices = [make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=SEED + s)[:2]
              for s in range(SLICES)]
    params = init_params(cfg, SEED)
    dense_ex = [ResampleTransform(ACCEL, cfg)(k, m) for k, m in slices]
    dense = Reconstructor(cfg, params)(next(batched(dense_ex, SLICES)))
    with _VDktPaths() as paths:
        packed = [CompactTransform(cfg, acceleration=ACCEL)(k, m)
                  for k, m in slices]
    check(paths.python == 0 and paths.native == SLICES,
          f"compact: VDkt masks native {paths.native}, Python {paths.python}")
    n_max = max(p["line_idx"].shape[-1] for p in packed)
    packed = [pad_lines(p, n_max) for p in packed]
    batch = {k: np.stack([p[k] for p in packed]) for k in packed[0]}
    outs, recs, mb = {}, {}, {"dense": wire_bytes(dense_ex[0]) / 1e6}
    for name in bench.E2E_WIRES:
        wire = (None if name == "dict" else
                FlatWire(packed[0], np.float16 if name == "flat16"
                         else np.float32))
        rec = CompactReconstructor(cfg, params, ny=Y, wire=wire)
        check(rec.device.type == "cuda", f"CompactReconstructor on "
              f"{rec.device}")
        inp = (batch if wire is None else
               np.stack([wire.encode(p) for p in packed]))
        mb[name] = (wire_bytes(packed[0]) if wire is None else
                    wire.length * wire.dtype.itemsize) / 1e6
        rec(inp)                                  # warm-up
        zero_counts()
        outs[name] = rec(inp)
        got = read_counts()
        for counter, n in got.items():
            counts[counter][f"{name} batch {SLICES}"] = n
        check(got["sense_normal"] == nunroll
              and sum(got.values()) == nunroll,
              f"compact {name} batch {SLICES}: launches {got}, expected "
              f"{nunroll} sense_normal")
        check(outs[name].shape == dense.shape and np.isfinite(
            outs[name]).all(), f"compact {name}: output {outs[name].shape}")
        recs[name] = rec
    peak = float(np.abs(dense).max())
    viol = _violation(outs["dict"], dense, COMPACT_RTOL, COMPACT_ATOL * peak)
    err = float(np.abs(outs["dict"] - dense).max())
    flat_equal = np.array_equal(outs["flat"], outs["dict"])
    err16 = float(np.abs(outs["flat16"] - outs["dict"]).max())
    print(f"compact: {SLICES} slices [{C},{T},{Y},{X}] E={E} at {ACCEL}x, "
          f"{n_max} lines a frame at most; batch {SLICES}: {nunroll} "
          "sense_normal launches per batch on each wire; dict vs dense "
          f"Reconstructor max abs err {err:.3e} (largest magnitude "
          f"{peak:.3e}; rtol {COMPACT_RTOL} atol {COMPACT_ATOL} of it: "
          f"excess {viol:.3e}); flat float32 equal to dict {flat_equal}; "
          f"flat float16 vs dict max abs err {err16:.3e} "
          f"({err16 / peak:.2e} of the largest)")
    print("compact: MB per slice on the wire: " + ", ".join(
        f"{k} {v:.4f}" for k, v in mb.items()))
    check(viol <= 0, f"compact dict vs dense: excess {viol:.3e}")
    check(flat_equal, "compact: flat float32 differs from dict")
    check(err16 <= COMPACT_F16_ATOL * peak,
          f"compact float16: {err16:.3e} > {COMPACT_F16_ATOL} x {peak:.3e}")
    one = {k: v[:1] for k, v in batch.items()}
    gpu = recs["dict"](one)
    t0 = time.perf_counter()
    cpu = CompactReconstructor(cfg, params, ny=Y, device="cpu")(one)
    rel = float(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu))
    print(f"compact: slice 0 vs the port's CPU compact path ({nunroll} "
          f"unrolls, {time.perf_counter() - t0:.1f} s on the CPU): rel L2 "
          f"{rel:.3e}")
    check(rel <= CPU_REL_L2_TOL, f"compact GPU vs CPU rel L2 {rel:.3e}")


def _to_device(variant, x):
    """A variant's input on the card as its reconstructor copies it."""
    if hasattr(variant.recon, "to_device"):
        return variant.recon.to_device(x)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in x.items()}


def compact_e2e(counts):
    """(c) The bench's end-to-end serving, dense and the three wires
    interleaved; the host, copy and device times of each beside it."""
    nunroll = headline_cfg().MODEL.PARAMETERS.NUM_UNROLLS
    with _VDktPaths() as paths:
        zero_counts()
        T, raw, variants, best = bench.measure_e2e(E2E_VARIANTS,
                                                   torch.device("cuda"))
        got = read_counts()
    reps = int(os.environ.get("BENCH_REPEATS", "3"))
    expected = nunroll * (1 + reps * len(raw)) * len(variants)
    for counter, n in got.items():
        counts[counter]["e2e"] = n
    check(got["sense_normal"] == expected and sum(got.values()) == expected,
          f"compact e2e: launches {got}, expected {expected} sense_normal")
    check(paths.python == 0 and paths.native > 0,
          f"compact e2e: VDkt masks native {paths.native}, Python "
          f"{paths.python}")
    for v in variants:
        t0 = time.perf_counter()
        inputs = [v.make_input(r) for r in raw]
        host_ms = (time.perf_counter() - t0) * 1e3 / len(raw)

        def copy(x, _v=v):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _to_device(_v, x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3
        h2d_ms = float(np.median([copy(x) for x in inputs]))
        _, busy = profile_device(f"compact e2e {v.name}: one slice",
                                 lambda _v=v, _x=inputs[0]: _v.recon(_x))
        print(f"compact e2e {v.name}: {len(raw) * T / best[v.name]:.1f} "
              f"frames/s ({best[v.name] * 1e3 / len(raw):.2f} ms a slice, "
              f"best of {reps} over {len(raw)} slices, host work on 2 "
              f"threads); host transform {host_ms:.2f} ms a slice (one "
              f"thread), host-to-device {h2d_ms:.3f} ms (median), device "
              f"{busy:.2f} ms of one profiled slice; {v.mb_per_slice:.4f} MB "
              "a slice on the wire")
    print(f"compact e2e: {nunroll} SENSE-normal launches a slice, "
          f"{got['sense_normal']} in all")


def phase_compact():
    """Compact serving: (a) native VDkt, (b) the wires against the dense
    path, (c) end-to-end frames/s."""
    counts = {name: {} for name in COUNTERS}
    compact_vdkt()
    compact_serving(counts)
    compact_e2e(counts)
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
    t_start = time.perf_counter()

    def timed(phase):
        t0 = time.perf_counter()
        out = phase()
        print(f"phase {phase.__name__[6:]}: {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s in all)")
        return out

    timed(phase_device)
    timed(phase_build)
    kres = timed(phase_kernels)
    counts = {name: timed(phase) for name, phase in (
        ("main", phase_main), ("swin", phase_swin), ("train", phase_train),
        ("dslr", phase_dslr), ("dslr_serve", phase_dslr_serve),
        ("headline", phase_headline),
        ("se", phase_se), ("modl", phase_modl), ("gan", phase_gan),
        ("pipeline", phase_pipeline))}
    counts["diffusion"], attention = timed(phase_diffusion)
    counts["swin_bf16"] = timed(phase_swin_bf16)
    counts["diffusion_bf16"] = timed(phase_diffusion_bf16)
    counts["multigpu"] = timed(phase_multigpu)
    counts["compact"] = timed(phase_compact)

    def by_path(name):
        return {path: c[name] for path, c in counts.items()}

    def attention_variants(name, side):
        """The Swin block's variants (batch, mask), then those a diffusion
        path's own inputs gave (path, mask), then the bfloat16 ones."""
        def mask(m):
            return f"mask={'shift' if m else 'none'}"
        return {**{f"B={B} {mask(m)}": r
                   for (B, m), r in kres[name].items()},
                **{f"{tag} {mask(m)}": r[side]
                   for (tag, m), r in attention.items()},
                **{f"bf16 {tag}": r for tag, r in
                   kres["window_attention_bf16"][side].items()}}

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
               attention_variants("window_attention", 0),
               by_path("window_attention")),
        _entry("window_attention_bwd",
               "dl_swin_gan_tpu_torch/kernels/csrc/window_attn_bwd.cu",
               "dl_swin_gan_tpu/kernels/window_attn.py:148",
               attention_variants("window_attention_bwd", 1),
               by_path("window_attention_bwd")),
        _entry("llr_normal",
               "dl_swin_gan_tpu_torch/kernels/csrc/llr_normal.cu",
               "dl_swin_gan_tpu/kernels/llr_normal.py:282",
               kres["llr_normal"],
               llr_by_path()),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
