"""Reading a torch.profiler trace of a short stretch of the timed path.

The stretch runs inside a `bench.window` range; its Chrome trace is written
gzipped to TMPDIR (a few MB), read, and deleted. From it:

  - kernels (and device copies and sets) with their device intervals,
    grouped by name with the pattern files of `benchmark/groups/<group>/`;
  - busy time: the union of those intervals inside the window, so kernels
    that overlap count once; the idle share is 1 - busy / window;
  - idle gaps, each labelled by what the host was doing at its middle: the
    innermost `bench.*` range of the harness, else the innermost operator.
"""

import gzip
import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np

from benchmark.harness import BENCH_DIR, load_json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_groups(root: Path = BENCH_DIR / "groups") -> List[Tuple]:
    """[(rank, pattern, group)] from every `<group>/*.json` file."""
    out = []
    for path in sorted(root.glob("*/*.json")):
        spec = load_json(path)
        for pattern in spec["patterns"]:
            out.append((int(spec["rank"]), pattern.lower(), path.parent.name))
    return out


def group_of(name: str, groups) -> str:
    """The group of a kernel name: of the matching patterns, the lowest
    rank, then the longest pattern; 'other' when none matches."""
    low = name.lower()
    hits = [(rank, -len(p), g) for rank, p, g in groups if p in low]
    return min(hits)[2] if hits else "other"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """One profiled stretch of `units` steps or slices."""

    def __init__(self, events: List[dict], units: int, groups=None):
        groups = load_groups() if groups is None else groups
        self.units = units
        windows = [e for e in events if e.get("name") == "bench.window"
                   and e.get("ph") == "X"]
        if not windows:
            raise ValueError("the trace holds no bench.window range")
        w = windows[0]
        self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.kernels = []           # (name, start us, end us, group, cat)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                a = max(float(e["ts"]), self.start)
                b = min(float(e["ts"]) + float(e["dur"]), self.end)
                if b > a:
                    self.kernels.append((e["name"], a, b,
                                         group_of(e["name"], groups),
                                         e["cat"]))
        host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                 e.get("cat") == "user_annotation")
                for e in events if e.get("ph") == "X"
                and e.get("cat") in ("user_annotation", "cpu_op")
                and e.get("name") != "bench.window"]
        self.host_names = [h[2] for h in host]
        self.host_span = np.asarray([h[:2] for h in host],
                                    dtype=np.float64).reshape(-1, 2)
        self.host_ours = np.asarray([h[3] for h in host], dtype=bool)
        self.busy = union([(a, b) for _, a, b, _, _ in self.kernels])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def group_ms(self, group: str) -> float:
        """Device ms of a group's kernels per unit (0.0 when none ran)."""
        return sum(b - a for _, a, b, g, _ in self.kernels
                   if g == group) / 1e3 / self.units

    def group_launches(self, group: str) -> int:
        return sum(1 for _, _, _, g, _ in self.kernels if g == group)

    def launches(self) -> float:
        """Kernel launches per unit (device copies and sets not counted)."""
        return sum(1 for *_, cat in self.kernels
                   if cat == "kernel") / self.units

    def by_group(self) -> Dict[str, float]:
        """Device seconds by group over the whole stretch."""
        out: Dict[str, float] = defaultdict(float)
        for _, a, b, g, _ in self.kernels:
            out[g] += (b - a) / 1e6
        return dict(out)

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_label(self, t: float) -> str:
        """What the host was doing at time t: the innermost harness range
        covering it, else the innermost operator, else 'host idle'."""
        a, b = self.host_span[:, 0], self.host_span[:, 1]
        covering = (a <= t) & (t <= b)
        for ours in (True, False):
            pick = np.flatnonzero(covering & (self.host_ours == ours))
            if pick.size:
                inner = pick[np.argmin((b - a)[pick])]
                return self.host_names[inner]
        return "host idle"

    def idle_by_host(self, labelled: int = 500) -> Dict[str, float]:
        """Idle seconds by host label; the `labelled` longest gaps are
        labelled one by one, the rest summed as short gaps."""
        gaps = sorted(self.gaps(), key=lambda ab: ab[0] - ab[1])
        out: Dict[str, float] = defaultdict(float)
        for a, b in gaps[:labelled]:
            out[self.host_label((a + b) / 2)] += (b - a) / 1e6
        if len(gaps) > labelled:
            cut = gaps[labelled - 1][1] - gaps[labelled - 1][0]
            out[f"gaps under {cut:.0f} us"] = sum(
                b - a for a, b in gaps[labelled:]) / 1e6
        return dict(out)

    def breakdown(self) -> dict:
        top = sorted(self.by_group().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[g, s] for g, s in top],
                "idle_gaps": [[g, s] for g, s in gaps[:10]]}


def profile(fn: Callable[[], None], units: int, sync: Callable[[], None]
            ) -> Trace:
    """Run fn() (units steps or slices) under torch.profiler inside a
    bench.window range and read its trace; the trace file lives in TMPDIR
    only while it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            fn()
            sync()
    fd, name = tempfile.mkstemp(suffix=".json.gz", prefix="bench_trace_")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(name)      # gzipped by torch: ".gz"
        with gzip.open(name, "rt") as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(name)
    finally:
        os.unlink(name)
    trace = Trace(events, units)
    trace.file_bytes, trace.read_s = size, time.perf_counter() - t0
    return trace
