"""The program's own spans in a profiled stretch: device time, launches and
idle by the layers of dl_swin_gan_tpu_torch.

The port opens `record_function` ranges named `<layer>.<part>`
(`dl_swin_gan_tpu_torch/utils/tracing.py`) while a profiler records. The
first reader on a traced run on the card that asks (`reading(ctx)`)
profiles one more stretch of `runner.profile_units()` units through
`runner.run_units` under torch.profiler (CPU and CUDA) inside a
`bench.window` range: after every reader before it, since BENCHMARK.json
lists the metrics that use it last and the harness reads them in file
order. It keeps the result on the reading context for the other readers,
puts back `runner.profiled`, and prints a summary line `spans {...}` on
standard error. From the raw Chrome trace:

  - each kernel, device copy and set inside the window is matched by its
    `correlation` to its launch record (a `cuda_runtime` or `cuda_driver`
    event), and charged to the path of program spans open on the launching
    thread at the launch, innermost first. Where the innermost open range
    there is a backward op (an autograd node, on the autograd thread), the
    path goes on from that op's forward op, found by the trace's `fwdbwd`
    flow or else by the op's `Sequence number`: a backward kernel is
    charged to the spans of the forward op it differentiates, and a remat
    recompute's kernels to the recompute's own spans, then to those of the
    forward op whose backward ran it;
  - an op launched in no program span is `outside` (the harness's own
    work); one with no launch record, or launched in backward ops none of
    which has a link, is `unmatched`;
  - each idle gap of the device inside the window is charged the same way
    at the gap's middle, on the thread that launches the op ending the
    gap; a gap that ends the window, or whose thread is in no program span
    at its middle (the main thread waiting on a host transform), is
    `outside`.

A metric reads the ops or gaps whose path holds one of a family of span
names (`Family`). Off the card, or where the trace holds no span of the
family (a program without spans), the reading is None and the metric is
left out: never 0 for lack of a reading.
"""

import bisect
import gzip
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from benchmark.trace import DEVICE_CATS, union

try:        # the first part of the program's span names
    from dl_swin_gan_tpu_torch.utils.tracing import LAYERS
except ImportError:     # a program without spans
    LAYERS = ()

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
BACKWARD = "autograd::engine::evaluate_function"
SPAN, OUTSIDE, UNMATCHED = "span", "outside", "unmatched"


def is_program(name: str) -> bool:
    head, dot, _ = name.partition(".")
    return bool(dot) and head in LAYERS


@dataclass(frozen=True)
class Family:
    """Span names a metric reads: these names, and names with these
    prefixes."""
    names: Tuple[str, ...] = ()
    prefixes: Tuple[str, ...] = ()

    def holds(self, name: str) -> bool:
        return name in self.names or name.startswith(self.prefixes)

    def on(self, path: Sequence[str]) -> bool:
        return any(self.holds(n) for n in path)


# the trunk: the solver's call into it, and its own spans (a recompute's
# too, which run on the autograd thread)
TRUNK = Family(("solver.denoise",), ("trunk.", "swin."))
DC = Family(("solver.dc",))
PIPELINE = Family((), ("pipeline.",))
COPIES = Family(("compact.upload", "compact.readback"))
RECONSTRUCT = Family(("compact.reconstruct",))


class _Thread:
    """The nested host ranges of one thread: the indexes of the ranges
    open at any time, innermost last."""

    def __init__(self, ranges: List[Tuple[float, float, int]]):
        points = []
        for a, b, i in ranges:
            if b > a:
                points.append((a, 1, -b, i))
                points.append((b, 0, -a, i))
        points.sort()
        stack: List[int] = []
        self.times: List[float] = []
        self.stacks: List[Tuple[int, ...]] = []
        for t, opening, _, i in points:
            if opening:
                stack.append(i)
            elif stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
            if self.times and self.times[-1] == t:
                self.stacks[-1] = tuple(stack)
            else:
                self.times.append(t)
                self.stacks.append(tuple(stack))

    def open_at(self, t: float) -> Tuple[int, ...]:
        k = bisect.bisect_right(self.times, t) - 1
        return self.stacks[k] if k >= 0 else ()


class Spans:
    """One profiled stretch of `units` steps or slices, attributed to the
    program's spans."""

    def __init__(self, events: List[dict], units: int):
        self.units = units
        windows = [e for e in events
                   if e.get("name") == WINDOW and e.get("ph") == "X"]
        if not windows:
            raise ValueError(f"the trace holds no {WINDOW} range")
        w = windows[0]
        self.start = float(w["ts"])
        self.end = self.start + float(w["dur"])

        flow_start, flow_end = {}, {}
        for e in events:
            if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
                side = flow_start if e["ph"] == "s" else flow_end
                side[e.get("id")] = (e.get("tid"), float(e["ts"]))
        flows = {flow_end[k]: v for k, v in flow_start.items()
                 if k in flow_end}

        self.span_names = set()
        self.span_count = 0
        self.ranges: List[Tuple[str, bool, Optional[Tuple]]] = []
        by_thread: Dict[object, List] = defaultdict(list)
        forward_at: Dict[int, Tuple] = {}
        pending = []            # backward ranges linked by sequence number
        launches = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), e.get("name", "")
            args = e.get("args") or {}
            tid, ts = e.get("tid"), float(e["ts"])
            if cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (tid, ts)
            elif cat == "user_annotation" and is_program(name):
                self.span_names.add(name)
                self.span_count += 1
                self._add(by_thread, tid, ts, e, name, False, None)
            elif cat == "cpu_op":
                seq = args.get("Sequence number")
                linked = flows.get((tid, ts))
                if linked is not None or name.startswith(BACKWARD):
                    i = self._add(by_thread, tid, ts, e, name, True, linked)
                    if linked is None and seq is not None:
                        pending.append((i, seq, ts))
                elif seq is not None:
                    seen = forward_at.get(seq)
                    if seen is None or ts < seen[1]:
                        forward_at[seq] = (tid, ts)
        for i, seq, ts in pending:
            fwd = forward_at.get(seq)
            if fwd is not None and fwd[1] < ts:
                name, _, _ = self.ranges[i]
                self.ranges[i] = (name, True, fwd)
        self.threads = {tid: _Thread(r) for tid, r in by_thread.items()}

        # (start, end, cat, path, status) of each device op in the window
        self.ops = []
        starting: Dict[float, Tuple] = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = max(float(e["ts"]), self.start)
            b = min(float(e["ts"]) + float(e["dur"]), self.end)
            if b <= a:
                continue
            launch = launches.get((e.get("args") or {}).get("correlation"))
            path, status = ((), UNMATCHED) if launch is None \
                else self.resolve(*launch)
            self.ops.append((a, b, e["cat"], path, status))
            if a not in starting:
                starting[a] = launch
        self.busy = union([(a, b) for a, b, *_ in self.ops])

        # (start, end, path, status) of each idle gap in the window
        self.gaps = []
        edges = [self.start] + [x for ab in self.busy for x in ab] \
            + [self.end]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            if b >= self.end:
                path, status = (), OUTSIDE
            else:
                launch = starting.get(b)
                path, status = ((), UNMATCHED) if launch is None \
                    else self.resolve(launch[0], (a + b) / 2)
            self.gaps.append((a, b, path, status))

    def _add(self, by_thread, tid, ts, e, name, backward, link) -> int:
        self.ranges.append((name, backward, link))
        i = len(self.ranges) - 1
        by_thread[tid].append((ts, ts + float(e.get("dur", 0.0)), i))
        return i

    def resolve(self, tid, t: float, depth: int = 0
                ) -> Tuple[Tuple[str, ...], str]:
        """(path of program spans, innermost first; status) of host time t
        on thread tid, backward ops followed to their forward ops."""
        thread = self.threads.get(tid)
        path: List[str] = []
        unlinked = False
        for i in reversed(thread.open_at(t) if thread else ()):
            name, backward, link = self.ranges[i]
            if not backward:
                path.append(name)
            elif link is None:
                unlinked = True
            else:
                if depth < 8:
                    path.extend(self.resolve(link[0], link[1],
                                             depth + 1)[0])
                return tuple(path), SPAN if path else OUTSIDE
        if path:
            return tuple(path), SPAN
        return (), UNMATCHED if unlinked else OUTSIDE

    # -- readings, per unit ----------------------------------------------
    def saw(self, family: Family) -> bool:
        """Whether the trace holds a span of the family."""
        return any(family.holds(n) for n in self.span_names)

    def device_ms(self, family: Family) -> float:
        return sum(b - a for a, b, _, path, _ in self.ops
                   if family.on(path)) / 1e3 / self.units

    def launches(self, family: Family) -> float:
        """Kernel launches (copies and sets not counted)."""
        return sum(1 for _, _, cat, path, _ in self.ops
                   if cat == "kernel" and family.on(path)) / self.units

    def idle_ms(self, family: Family) -> float:
        return sum(b - a for a, b, path, _ in self.gaps
                   if family.on(path)) / 1e3 / self.units

    def shares(self) -> Dict[str, float]:
        """% of device time by status: span, outside, unmatched."""
        total = sum(b - a for a, b, *_ in self.ops) or 1.0
        out = {SPAN: 0.0, OUTSIDE: 0.0, UNMATCHED: 0.0}
        for a, b, _, _, status in self.ops:
            out[status] += 100.0 * (b - a) / total
        return out

    def by_span(self) -> Dict[str, float]:
        """Device ms per unit by innermost span (or status)."""
        out: Dict[str, float] = defaultdict(float)
        for a, b, _, path, status in self.ops:
            out[path[0] if path else status] += (b - a) / 1e3 / self.units
        return dict(out)

    def idle_by_span(self) -> Dict[str, float]:
        """Idle ms per unit by innermost span (or status)."""
        out: Dict[str, float] = defaultdict(float)
        for a, b, path, status in self.gaps:
            out[path[0] if path else status] += (b - a) / 1e3 / self.units
        return dict(out)

    def summary(self) -> dict:
        def top(d, n):
            return [[k, round(v, 4)] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:n]]

        return {"units": self.units, "spans": self.span_count / self.units,
                "window_ms": (self.end - self.start) / 1e3,
                "busy_ms": sum(b - a for a, b in self.busy) / 1e3,
                "device_share": {k: round(v, 3)
                                 for k, v in self.shares().items()},
                "device_ms": top(self.by_span(), 16),
                "idle_ms": top(self.idle_by_span(), 10)}


def profile_events(fn: Callable[[], None], sync: Callable[[], None]
                   ) -> List[dict]:
    """The raw Chrome trace events of fn() under torch.profiler (CPU and
    CUDA) inside a bench.window range; the file lives in TMPDIR only
    while it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            sync()
    fd, name = tempfile.mkstemp(suffix=".json.gz", prefix="bench_spans_")
    os.close(fd)
    try:
        prof.export_chrome_trace(name)
        with gzip.open(name, "rt") as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(name)


_NOT_READ = object()


def reading(ctx) -> Optional[Spans]:
    """The cell's attributed stretch, profiled once per run (None off the
    card)."""
    if ctx.trace is None:
        return None
    got = getattr(ctx, "program_spans", _NOT_READ)
    if got is _NOT_READ:
        runner = ctx.runner
        saved = runner.__dict__.get("profiled", _NOT_READ)
        t0 = time.perf_counter()
        n = runner.profile_units()
        try:
            got = Spans(profile_events(lambda: runner.run_units(n),
                                       runner.sync), n)
        finally:
            if saved is _NOT_READ:
                runner.__dict__.pop("profiled", None)
            else:
                runner.profiled = saved
        ctx.program_spans = got
        summary = dict(got.summary(), read_s=time.perf_counter() - t0)
        print("spans " + json.dumps(summary), file=sys.stderr, flush=True)
    return got


def read(ctx, what: str, family: Family) -> Optional[float]:
    """`Spans.<what>(family)` of the cell's stretch: `device_ms`,
    `launches` or `idle_ms`; None off the card or where the trace holds no
    span of the family."""
    s = reading(ctx)
    return getattr(s, what)(family) if s is not None and s.saw(family) \
        else None


def phase_s(ctx, names: Sequence[str]) -> Optional[float]:
    """Host seconds of the program's set-up phases `names`, summed, from
    `utils/tracing.py phases()`; None off the card or where the program
    times none of them."""
    if ctx.trace is None:
        return None
    try:
        from dl_swin_gan_tpu_torch.utils.tracing import phases
    except ImportError:
        return None
    timed = phases()
    if not all(n in timed for n in names):
        return None
    return sum(timed[n] for n in names)
