"""Spans of the hot path and timed set-up phases.

`span(name)` names a stretch of the hot path: an unroll, its data
consistency, the trunk and its blocks, the trainer's step, the device
pipeline, compact serving. With no torch profiler running it returns a
shared null context after one read of torch's own "profiler on" flag: no
allocation and no `record_function` entry, so the spans cost nothing worth
measuring and no switch turns them on. Under any torch profiler (an
operator's `torch.profiler.profile`, fit's `DL_SWIN_GAN_PROFILE` trace, a
benchmark's profiled stretch) it enters `torch.profiler.record_function`,
so the span lands in the Kineto trace on the device kernels' clock, as a
`user_annotation` range on the thread that opened it. Spans launch nothing.

    with span("solver.unroll"):
        ...

A span carries no arguments: torch's Chrome export drops the `args` of a
`record_function`, so the unroll or request a span belongs to is read from
its order on its thread.

`phase(name)` times one-off set-up work (building a trainer, its state, a
solver, a reconstructor, a kernel library) on the host clock, always: the
seconds add up under `name` in a process-wide table that `phases()`
returns. While a profiler runs a phase is a span too. It is a context
manager and a decorator; as a context manager it yields a `Timer` whose
`seconds` is set on exit.

Span names are literal strings `<layer>.<part>`; the layers are listed in
`LAYERS`.
"""

import contextlib
import threading
import time
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

# the first part of every span name
LAYERS = ("solver", "trunk", "swin", "trainer", "pipeline", "compact",
          "kernels")

_OFF = contextlib.nullcontext()
_PHASES: Dict[str, float] = {}
_LOCK = threading.Lock()


def span(name: str):
    """A `record_function(name)` range while a profiler records, else a
    shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class Timer:
    """The host seconds of one phase, set when it ends."""
    seconds: float = 0.0


@contextlib.contextmanager
def phase(name: str):
    """Time the block (or the decorated call) into `phases()[name]`."""
    timer = Timer()
    t0 = time.perf_counter()
    try:
        with span(name):
            yield timer
    finally:
        timer.seconds = time.perf_counter() - t0
        with _LOCK:
            _PHASES[name] = _PHASES.get(name, 0.0) + timer.seconds


def phases() -> Dict[str, float]:
    """Host seconds of every phase so far in this process, by name."""
    with _LOCK:
        return dict(_PHASES)
