#!/usr/bin/env python3
"""Readings the check's limits are set from, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 3,4,5] [--fault half_batch --fault-seeds 6,7,8] \
        [--seconds S] [--device cpu]

For each seed of --seeds it builds the cell as a run does, drives its
first steps (a serving cell: a window of --seconds), and prints the
numbers the check compares, program against reference: the lower
readings; for a train cell also the three worst leaves of the gradient and
change gaps (name, gap, the side's norm, the reference's norm). For each
of --control-seeds it puts the reference, its trunk computed one precision
below the configuration's (`harness.CONTROL_BELOW`), in the program's
place: the upper readings. A --fault (benchmark/faults.py) runs the program with that fault
planted. One JSON line a seed, then a summary line: per number the largest
program reading and the smallest control and fault readings, beside the
cell's limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch

    from benchmark import faults, harness

    cell = harness.load_cell(args.workload, dry_run=args.device == "cpu")
    torch.set_num_threads(harness.TORCH_THREADS)
    device = torch.device(args.device)
    make = harness.load_runner(cell.traffic["runner"])
    kinds = ([("program", s, None) for s in args.seeds]
             + [("control", s, None) for s in args.control_seeds]
             + [(f, s, f) for f in args.fault for s in args.fault_seeds])
    summary = {}
    for kind, seed, fault in kinds:
        t0 = time.perf_counter()
        runner = make(cell, device, seed)
        planted = faults.FAULTS[fault]() if fault else None
        if planted:
            planted.__enter__()
        try:
            runner.setup()
            if runner.unit == "slice":
                runner.window(args.seconds)
        finally:
            if planted:
                planted.__exit__(None, None, None)
        runner.free()
        ref = runner.reference(runner.precision)
        if kind == "control":
            low = runner.reference(harness.CONTROL_BELOW[runner.precision])
            side = (runner.control_side(low) if runner.unit == "slice"
                    else {**low, "batches": low["batches"][:1]})
        else:
            side = runner.program_side()
        readings = runner.readings(side, ref)
        line = {"kind": kind, "seed": seed, "readings": readings,
                "seconds": time.perf_counter() - t0}
        if runner.unit == "slice":
            line["answers"] = len(runner.answers)
        else:
            line["left_out"] = runner.left_out
            line["worst"] = runner.worst
        print(json.dumps(line), flush=True)
        for k, v in readings.items():
            summary.setdefault(kind, {}).setdefault(k, []).append(v)
        del runner, ref, side
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {k: {"limit": cell.traffic["limits"].get(k)}
           for k in next(iter(summary.values()), {})}
    for kind, numbers in summary.items():
        for k, values in numbers.items():
            out[k]["program_max" if kind == "program" else f"{kind}_min"] = (
                max(values) if kind == "program" else min(values))
    print(json.dumps({"summary": out, "workload": args.workload}), flush=True)


if __name__ == "__main__":
    main()
