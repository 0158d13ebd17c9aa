#!/usr/bin/env python3
"""The benchmark of dl_swin_gan_tpu_torch, one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--device cpu]

Builds the cell's timed path from its files (BENCHMARK.json, the
configuration's and the cell's own), warms it up, measures it for
--seconds, then checks what it produced against the plain reference and
prints one JSON line: `correct`, `attempted`, `failed`, `metrics`,
`device`, with --trace 1 `breakdown`, `host` (what the host and the card
did in the window: `harness.host_window`), and last `checks`, each number
compared beside its limit (also the last lines of standard error). With
--trace 0 the metrics are the cell's end-to-end metrics; with --trace 1
its per-layer metrics, read from the unprofiled window and a short
profiled stretch after it.

It needs as many CUDA cards as the cell asks for, and exits with 3 and no
result without them. `--device cpu` is a dry run at the tiny geometry of
the files' `dry_run` blocks, which prints no device metric.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# fixed cache directories inside the checkout, so that a run finds what the
# first run there built
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "benchmark" / ".cache" / _dir)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def fail(code: int, message: str):
    print(message, file=sys.stderr, flush=True)
    raise SystemExit(code)


def per_layer(cell, runner, run, trace, peak) -> dict:
    from benchmark.readers import Context, load_reader

    ctx = Context(cell, runner, run, trace, peak)
    out = {}
    for name in cell.per_layer():
        value = load_reader(name)(ctx)
        if value is not None:
            out[name] = {"value": float(value),
                         "unit": cell.metrics[name]["unit"]}
    return out


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    from benchmark import harness

    dry = args.device == "cpu"
    cell = harness.load_cell(args.workload, dry_run=dry)
    if not dry:
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available():
            fail(3, "no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            fail(3, f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} present")
    torch.set_num_threads(harness.TORCH_THREADS)
    device = torch.device(args.device)
    runner = harness.load_runner(cell.traffic["runner"])(cell, device,
                                                         args.seed)
    runner.setup()
    runner.sync()
    setup_s = time.perf_counter() - START

    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_reserved(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = harness.host_state(device)
    run = runner.window(args.seconds, events=bool(args.trace))
    host = harness.host_window(before, harness.host_state(device),
                               run["elapsed"])
    metrics, breakdown, trace = {}, None, None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if args.trace:
        if device.type == "cuda":
            from benchmark.trace import profile
            n = runner.profile_units()
            trace = profile(lambda: runner.run_units(n), n, runner.sync)
            breakdown = trace.breakdown()
        metrics = per_layer(cell, runner, run, trace, peak)
    else:
        metrics = {name: {"value": float(run["e2e"][name]),
                          "unit": cell.metrics[name]["unit"]}
                   for name in cell.end_to_end() if name != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = harness.card(device)
    if device.type == "cuda":
        dev["memory_peak_bytes"] = max(dev["memory_peak_bytes"], setup_peak)
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
    if dry:
        dev = {k: v for k, v in dev.items() if k in ("platform", "count")}
    runner.free()

    ref = runner.reference(runner.precision)
    readings = runner.readings(runner.program_side(), ref)
    limits = cell.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()
              if k in limits}
    correct = all(harness.finite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    found = harness.forbidden_modules()
    if found:
        fail(4, "the run loaded modules it may not: " + ", ".join(found))
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["host"] = host
    result["checks"] = checks
    print("host " + json.dumps(host), file=sys.stderr)
    for name, value in readings.items():
        if name not in checks:
            print(f"reading {name} {value!r} (printed, not compared)",
                  file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
