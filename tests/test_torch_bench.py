"""The port's bench (`python -m dl_swin_gan_tpu_torch.bench`) on the CPU at a
toy shape: one JSON line of the root bench.py's format with the port's
keys, for the headline train step and for BENCH_WORKLOAD=recon; no card
numbers from a CPU run, and no run without a card unless the CPU is asked
for."""

import json

import pytest
import torch

from dl_swin_gan_tpu_torch import bench

torch.set_num_threads(1)

TOY = {"BENCH_SHAPE": "6,48,16,2", "BENCH_ITERS": "1", "BENCH_REPEATS": "1",
       "BENCH_OPTS": "MODEL.PARAMETERS.NUM_FEATURES 8 "
                     "MODEL.PARAMETERS.NUM_UNROLLS 2"}
COMMON = {"metric", "value", "unit", "vs_baseline", "batch", "trunk_dtype",
          "tflops", "mfu", "peak_mem_gb", "flop_source", "device",
          "power_limit"}


def _run(monkeypatch, capsys, **env):
    for key, value in {**TOY, **env}.items():
        monkeypatch.setenv(key, value)
    rec = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == rec
    return rec


def test_headline_line(monkeypatch, capsys):
    rec = _run(monkeypatch, capsys)
    assert set(rec) == COMMON | {"remat", "bs1_it_s", "bs1_tflops",
                                 "bs1_mfu", "f32_samples_per_s",
                                 "f32_tflops", "f32_mfu", "f32_peak_mem_gb"}
    assert rec["metric"] == "unrolled_resnet_train_throughput"
    assert rec["unit"] == "it/s" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / bench.BASELINE_IT_S, 3)
    assert (rec["batch"], rec["remat"], rec["trunk_dtype"]) == (
        16, True, "bfloat16")
    assert rec["bs1_it_s"] > 0 and rec["f32_samples_per_s"] > 0
    assert "FlopCounterMode" in rec["flop_source"]
    # a CPU run gives no card numbers
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["tflops"] is None and rec["mfu"] is None


def test_explicit_batch_and_recon_lines(monkeypatch, capsys):
    rec = _run(monkeypatch, capsys, BENCH_BATCH="2", BENCH_DTYPE="float32")
    assert set(rec) == COMMON | {"remat"}
    assert (rec["batch"], rec["remat"], rec["trunk_dtype"]) == (
        2, True, "float32")
    monkeypatch.delenv("BENCH_BATCH")
    rec = _run(monkeypatch, capsys, BENCH_WORKLOAD="recon",
               BENCH_DTYPE="bfloat16")
    assert set(rec) == COMMON
    assert rec["metric"] == "unrolled_resnet_recon_throughput"
    assert rec["unit"] == "frames/s" and rec["batch"] == 4
    assert rec["vs_baseline"] == round(
        rec["value"] / bench.BASELINE_RECON_FPS, 3)


def test_flops_count_convs_and_the_sense_kernel(monkeypatch):
    """One train step's count: FlopCounterMode's convolutions and the
    analytic SENSE-normal count, 2 * unrolls - 1 launches."""
    for key, value in TOY.items():
        monkeypatch.setenv(key, value)
    step = bench.TrainStep(1, False, "float32", torch.device("cpu"))
    assert step.sense_launches == 3
    sense = bench.sense_flops(step.batch, step.sense_launches)
    total = bench.counted_flops(step, step.batch, step.sense_launches)
    assert sense > 0 and total > 2 * sense


def test_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


def test_unknown_workload_raises(monkeypatch):
    monkeypatch.setenv("BENCH_WORKLOAD", "swin")
    with pytest.raises(ValueError, match="BENCH_WORKLOAD"):
        bench.main(["--device", "cpu"])
