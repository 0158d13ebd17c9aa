"""The port's bench (`python -m dl_swin_gan_tpu_torch.bench`) on the CPU at a
toy shape: one JSON line of the root bench.py's format with the port's
keys, for the headline train step, for BENCH_WORKLOAD=recon and for the
end-to-end serving workloads (recon_e2e, recon_e2e_compact, recon_e2e_wire:
the root bench.py's metric names); no card numbers from a CPU run, and no
run without a card unless the CPU is asked for."""

import importlib.util
import json
from pathlib import Path

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


E2E = {"BENCH_SLICES": "2", "BENCH_REPEATS": "1"}
E2E_KEYS = {"metric", "value", "unit", "vs_baseline", "wire_mb_per_slice",
            "slices", "acceleration", "device", "power_limit"}


def _root_bench():
    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("root_bench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_compact_metrics(monkeypatch, wires):
    """The metric names the root bench.py's compact workload prints for
    `wires`: its own emit loop, run on stand-in variants."""
    root = _root_bench()
    names = []
    monkeypatch.setattr(root, "_compact_e2e_variants", lambda wanted: (
        1, 1, [None], [(w, lambda r: None, lambda x: None, 1.0)
                        for w in wanted]))
    monkeypatch.setattr(root, "_compact_run_once", lambda *a: 1.0)
    monkeypatch.setattr(root, "_emit", lambda metric, *a, **k:
                        names.append(metric))
    if len(wires) > 1:
        root.bench_recon_e2e_compact(probe_all=True)
    else:
        monkeypatch.setenv("BENCH_WIRE", wires[0])
        root.bench_recon_e2e_compact()
    return names


def _run_lines(monkeypatch, capsys, **env):
    for key, value in {**TOY, **E2E, **env}.items():
        monkeypatch.setenv(key, value)
    recs = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == recs
    return recs


@pytest.mark.parametrize("workload,wire", [
    ("recon_e2e", None), ("recon_e2e_compact", "dict"),
    ("recon_e2e_compact", "flat16"), ("recon_e2e_wire", None)])
def test_e2e_lines(workload, wire, monkeypatch, capsys):
    """Each end-to-end workload at the toy shape on 2 slices: its lines'
    keys and metric names, the root bench.py's (the dense line's is its
    literal; the compact ones its own loop prints), and the wire sizes:
    flat16 half of flat, dense above the compact wires."""
    env = {"BENCH_WORKLOAD": workload}
    if wire:
        env["BENCH_WIRE"] = wire
    recs = _run_lines(monkeypatch, capsys, **env)
    for rec in recs:
        assert set(rec) == E2E_KEYS
        assert rec["unit"] == "frames/s" and rec["value"] > 0
        assert rec["slices"] == 2 and rec["acceleration"] == 12.0
        assert rec["device"] == "cpu" and rec["power_limit"] is None
    metrics = [rec["metric"] for rec in recs]
    mb = {rec["metric"]: rec["wire_mb_per_slice"] for rec in recs}
    if workload == "recon_e2e":
        assert metrics == ["unrolled_resnet_recon_e2e_throughput"]
        assert '"unrolled_resnet_recon_e2e_throughput"' in (
            Path(__file__).resolve().parent.parent / "bench.py").read_text()
        return
    wires = [wire] if wire else ["dict", "flat", "flat16"]
    assert metrics == _jax_compact_metrics(monkeypatch, wires)
    if not wire:
        flat, flat16 = metrics[1], metrics[2]
        assert abs(mb[flat16] - mb[flat] / 2) < 1e-3
        assert mb[metrics[0]] >= mb[flat]


def test_e2e_default_wire_and_unknown_wire(monkeypatch, capsys):
    """recon_e2e_compact takes the flat wire unless BENCH_WIRE says
    otherwise, as the root bench.py does; an unknown wire raises."""
    (rec,) = _run_lines(monkeypatch, capsys,
                        BENCH_WORKLOAD="recon_e2e_compact")
    assert [rec["metric"]] == _jax_compact_metrics(monkeypatch, ["flat"])
    monkeypatch.setenv("BENCH_WIRE", "json")
    with pytest.raises(ValueError, match="BENCH_WIRE"):
        bench.main(["--device", "cpu"])
