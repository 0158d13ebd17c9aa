"""What every cell shares: finding a cell's files by name, the program's
config, seeds, the card, the import check and the result line.

A cell is an entry of `workloads` in BENCHMARK.json. Its configuration is
`benchmark/configs/<config>.json` (the file the entry of `configs` names)
and its traffic, check limits and runner are `benchmark/cells/<cell>.json`.
Nothing here is specific to one cell: a new cell is new data files.
"""

import importlib
import json
import math
import os
import resource
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names the measured process may not hold (the JAX package
# and JAX itself), compared whole: `dl_swin_gan_tpu_torch` is the program
FORBIDDEN = ("jax", "jaxlib", "flax", "dl_swin_gan_tpu")
# the host's torch threads in every run of every cell
TORCH_THREADS = 4
# the check's control: the reference one precision below the trunk's
CONTROL_BELOW = {"float32": "tf32", "bfloat16": "fp8"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell: its BENCHMARK.json entry, configuration and traffic."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    dry_run: bool = False
    metrics: Dict[str, dict] = field(default_factory=dict)

    @property
    def geometry(self) -> Dict[str, int]:
        g = dict(self.config["geometry"])
        if self.dry_run:
            g.update(self.config["dry_run"]["geometry"])
        return g

    @property
    def spec(self) -> dict:
        """The model as the reference builds it."""
        s = dict(self.config["model"])
        if self.dry_run:
            s.update(self.config["dry_run"].get("model", {}))
        return s

    def param(self, key: str):
        """A traffic parameter, its dry-run value in a dry run."""
        if self.dry_run and key in self.traffic.get("dry_run", {}):
            return self.traffic["dry_run"][key]
        return self.traffic[key]

    def end_to_end(self) -> List[str]:
        return [m["name"] for m in self.metrics.values()
                if m["kind"] == "end_to_end"
                and self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[str]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = set(self.end_to_end())
        return [m["name"] for m in self.metrics.values()
                if m["kind"] == "per_layer"
                and (self.name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e)]


def load_cell(name: str, dry_run: bool = False) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    metrics = {m["name"]: dict(m, kind="end_to_end")
               for m in bench["end_to_end"]}
    metrics.update({m["name"]: dict(m, kind="per_layer")
                    for m in bench["per_layer"]})
    return Cell(name, entry, load_json(ROOT / conf["file"]),
                load_json(BENCH_DIR / "cells" / f"{name}.json"), dry_run,
                metrics)


def program_cfg(cell: Cell):
    """The program's config: its defaults, then the settings of the
    configuration's file (the repo YAML it names, as dotted keys, and the
    keys its `reduced` lists)."""
    from dl_swin_gan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    settings = dict(cell.config["cfg"])
    if cell.dry_run:
        settings.update(cell.config["dry_run"].get("cfg", {}))
    for key, value in settings.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        if leaf not in node:
            raise KeyError(f"{cell.config['name']}: unknown config key {key}")
        node[leaf] = tuple(value) if isinstance(value, list) else value
    cfg.freeze()
    return cfg


def trunk_precision(cfg) -> str:
    """The precision the configuration states for the trunk's products,
    which the reference computes in: `float32` or `bfloat16`."""
    return str(cfg.MODEL.PARAMETERS.CONV_BLOCK.DTYPE)


def load_runner(name: str):
    """The runner class of a cell file's `runner`:
    `benchmark/runners/<name>.py` defines `Runner`."""
    return importlib.import_module(f"benchmark.runners.{name}").Runner


def derive(seed: int, *keys: int) -> int:
    """A 32-bit seed for one use of the run's --seed."""
    return int(np.random.SeedSequence([int(seed), *keys]).generate_state(1)[0])


def card(device) -> dict:
    """The run's `device` object, and the card's power limit."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    index = device.index or 0
    limit = (lines[index].split(",")[-1].strip()
             if smi.returncode == 0 and len(lines) > index else "unknown")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(device)),
            "power_limit": limit}


def host_state(device) -> dict:
    """What the host and the card are doing, read on each side of the
    window: the cores this process may run on, its CPU seconds (all its
    threads), and the card's SM clock (MHz), temperature (C) and power
    draw (W)."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cores": len(os.sched_getaffinity(0)),
           "cpu_s": use.ru_utime + use.ru_stime}
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        fields = smi.stdout.strip().split(",")
        if smi.returncode == 0 and len(fields) == 3:
            for key, text in zip(("sm_mhz", "temp_c", "power_w"), fields):
                try:
                    out[key] = float(text)
                except ValueError:
                    pass
    return out


def host_window(before: dict, after: dict, seconds: float) -> dict:
    """The window's host side from two `host_state` readings: the cores
    this process used on average, and the card's readings before and
    after."""
    out = {"cores": after["cores"],
           "cores_used": (after["cpu_s"] - before["cpu_s"]) / seconds}
    for key in ("sm_mhz", "temp_c", "power_w"):
        if key in before and key in after:
            out[key] = [before[key], after[key]]
    return out


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def gap(prog: float, ref: float, floor: float) -> float:
    """|prog - ref| as a share of max(|ref|, floor)."""
    return abs(prog - ref) / max(abs(ref), floor, 1e-30)


def p95(values) -> float:
    """The 95th percentile of all values (linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
