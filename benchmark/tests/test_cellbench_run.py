"""Whole runs of each cell on the CPU at the dry-run geometry: the result
line's keys, no device metric, the check passing on the program and
failing with a fault planted under the timed path."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness
from benchmark import run as bench_run

CELLS = ["res.train_b16_bf16", "swin.train_b1", "res.serve_compact"]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "host",
        "checks"}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    yield
    torch.set_num_threads(saved)


def dry(cell, seed=2147483713, trace=0, seconds=0.5):
    return bench_run.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace),
                           "--device", "cpu"])


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_line(cell, capsys):
    result = dry(cell)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0 and line["host"]["cores"] >= 1
    c = harness.load_cell(cell)
    assert set(line["metrics"]) == set(c.end_to_end())
    assert line["device"] == {"platform": "cpu", "count": 1}
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and " limit " in s for s in last)


@pytest.mark.parametrize("cell", ["res.train_b16_bf16", "res.serve_compact"])
def test_dry_trace_prints_no_device_metric(cell, capsys):
    line = dry(cell, trace=1)
    c = harness.load_cell(cell)
    assert "busy_s" not in line["device"] and "breakdown" not in line
    for name in line["metrics"]:
        assert c.metrics[name]["source"] == "host_clock", name


@pytest.mark.parametrize("cell,fault", [
    ("res.train_b16_bf16", "unchanged_state"),
    ("res.train_b16_bf16", "half_batch"),
    ("swin.train_b1", "unchanged_state"),
    ("res.serve_compact", "altered_answer"),
])
def test_fault_under_the_timed_path_fails_the_check(cell, fault, capsys):
    with faults.FAULTS[fault]():
        line = dry(cell)
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed


def test_no_card_no_result():
    """Without CUDA the run exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         "res.serve_compact", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
