"""What a per-layer metric's reader gets, and how readers are found.

`benchmark/metrics/<metric>.py` defines `read(ctx)`, which returns the
metric's value or None when this run has nothing to read for it (no trace,
no kernel of its group); the harness then leaves the metric out. A share
of a peak or a roofline is never returned as 0 for lack of a reading.
"""

import importlib.util
from functools import cached_property
from typing import Callable, Optional

from benchmark import harness
from benchmark.work import peaks, sense_normal, window_attn
from benchmark.work.model_flops import count as model_flops


def load_reader(name: str) -> Callable:
    path = harness.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Context:
    """A traced run: the cell, its runner, the unprofiled window's numbers
    (`run`) and the profiled stretch (`trace`, None off the card)."""

    def __init__(self, cell, runner, run: dict, trace, peak_allocated):
        self.cell, self.runner, self.run = cell, runner, run
        self.trace = trace
        self.peak_allocated = peak_allocated

    @property
    def training(self) -> bool:
        return self.cell.traffic["runner"] == "train"

    @property
    def precision(self) -> str:
        """The precision the configuration states for its trunk."""
        return self.runner.precision

    def group_ms(self, group: str) -> Optional[float]:
        """Device ms of a kernel group per step or slice, None when the
        trace holds none of its kernels."""
        if self.trace is None or not self.trace.group_launches(group):
            return None
        return self.trace.group_ms(group)

    @cached_property
    def flops_per_unit(self) -> float:
        """Model FLOPs of one step (all its examples) or one slice."""
        cell = self.cell
        if self.training:
            accel = sum(self.runner.cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS
                        ) / 2
        else:
            accel = float(cell.param("acceleration"))
        batch = cell.param("batch") if self.training else 1
        return batch * model_flops(cell.spec, cell.geometry,
                                   self.runner.shapes, self.training, accel)

    def mfu(self) -> Optional[float]:
        """% of the trunk precision's peak: model FLOPs per unit over the
        unprofiled window's seconds per unit."""
        if self.trace is None:
            return None
        return (100.0 * self.flops_per_unit / self.run["unit_s"]
                / peaks.FLOPS[self.precision])

    def roofline(self, group: str, calls: Callable, precision: str
                 ) -> Optional[float]:
        """% : the least time of the traced stretch's operator calls,
        `calls()` [(FLOP, bytes)], over the device time of the group's
        kernels there."""
        if self.trace is None or not self.trace.group_launches(group):
            return None
        device_s = self.trace.group_ms(group) * self.trace.units / 1e3
        least = sum(peaks.least_seconds(f, b, precision) for f, b in calls())
        return 100.0 * least / device_s

    def sense_calls(self):
        g = self.cell.geometry
        return [sense_normal.work(g["E"], g["C"], g["Y"], g["X"], rows)
                for rows in self.runner.sense_rows()]

    def attention_calls(self, backward: bool):
        io = 2 if self.precision == "bfloat16" else 4
        fwd, bwd = self.runner.attention_calls()
        fn = window_attn.backward if backward else window_attn.forward
        return [fn(*c, io_bytes=io) for c in (bwd if backward else fwd)]
