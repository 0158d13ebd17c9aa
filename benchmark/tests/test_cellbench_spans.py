"""The program-span attribution of `benchmark/spans.py` on a hand-made trace:
kernels matched to runtime and driver launches by correlation, nested
spans on two threads, backward ops linked to their forward ops by
sequence number and by `fwdbwd` flow, a remat recompute's spans inside a
backward op, idle gaps charged at their middle on the launching thread;
and the CPU dry run, which prints none of the metrics that read spans."""

import json

import pytest

from benchmark import harness, spans
from benchmark import run as bench_run

MAIN, AUTOGRAD, OTHER = 101, 202, 303
NEW = ["trunk_ms.train", "dc_ms.train", "trunk_launches.train",
       "trunk_idle_ms.train", "pipeline_idle_ms.train",
       "program_init_s.train", "trunk_ms.serve", "copy_idle_ms.serve",
       "reconstruct_idle_ms.serve", "program_init_s.serve"]


def X(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def span(name, tid, ts, end):
    return X("user_annotation", name, tid, ts, end - ts)


def launch(tid, ts, corr, driver=False):
    return X("cuda_driver" if driver else "cuda_runtime",
             "cuLaunchKernel" if driver else "cudaLaunchKernel", tid, ts, 2,
             correlation=corr)


def device(corr, ts, end, cat="kernel"):
    return X(cat, f"k{corr}", 7, ts, end - ts, correlation=corr)


def events():
    """One step, times in us. Main thread: trainer.forward > solver.unroll >
    solver.dc (a mul, seq 6, flow 11) and solver.denoise > trunk.block (a
    conv, seq 5); the harness's bench.build; trainer.backward. Autograd
    thread: the conv's backward (linked by sequence number only) with a
    recompute's trunk.head inside, the mul's backward (linked by flow), an
    AccumulateGrad with no link. A third thread's pipeline.draw."""
    return [
        span("bench.window", MAIN, 0, 1000),
        span("trainer.forward", MAIN, 10, 400),
        span("solver.unroll", MAIN, 15, 300),
        span("solver.dc", MAIN, 30, 100),
        X("cpu_op", "aten::mul", MAIN, 40, 10, **{"Sequence number": 6}),
        {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 11,
         "tid": MAIN, "ts": 40},
        span("solver.denoise", MAIN, 100, 290),
        span("trunk.block", MAIN, 110, 280),
        X("cpu_op", "aten::convolution", MAIN, 130, 10,
          **{"Sequence number": 5}),
        X("user_annotation", "bench.build", MAIN, 500, 100),
        span("trainer.backward", MAIN, 600, 990),
        X("cpu_op", "autograd::engine::evaluate_function: ConvBackward0",
          AUTOGRAD, 640, 160, **{"Sequence number": 5}),
        span("trunk.head", AUTOGRAD, 645, 700),
        X("cpu_op", "autograd::engine::evaluate_function: MulBackward0",
          AUTOGRAD, 820, 20, **{"Sequence number": 6}),
        X("cpu_op", "MulBackward0", AUTOGRAD, 821, 18,
          **{"Sequence number": 6}),
        {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 11, "bp": "e",
         "tid": AUTOGRAD, "ts": 821},
        X("cpu_op", "autograd::engine::evaluate_function: "
          "torch::autograd::AccumulateGrad", AUTOGRAD, 850, 20),
        span("pipeline.draw", OTHER, 300, 700),
        launch(MAIN, 35, 1), device(1, 40, 90),               # dc
        launch(MAIN, 135, 2), device(2, 150, 350),            # trunk.block
        launch(MAIN, 285, 3, driver=True), device(3, 400, 450),  # denoise
        launch(MAIN, 550, 4), device(4, 560, 580, "gpu_memcpy"),  # outside
        launch(AUTOGRAD, 650, 9), device(9, 660, 700),        # recompute
        launch(AUTOGRAD, 720, 5), device(5, 720, 760),        # conv bwd
        launch(AUTOGRAD, 825, 6), device(6, 830, 850),        # mul bwd
        launch(AUTOGRAD, 860, 7), device(7, 860, 870),        # unlinked
        device(8, 900, 910),                                  # no launch
    ]


@pytest.mark.parametrize("units", [1, 2])
def test_device_time_launches_and_idle_by_span(units):
    s = spans.Spans(events(), units)
    # trunk: k2 200 + k3 50 + k9 40 (recompute) + k5 40 (linked backward)
    assert s.device_ms(spans.TRUNK) == pytest.approx(0.330 / units)
    assert s.device_ms(spans.DC) == pytest.approx(0.070 / units)  # k1, k6
    assert s.launches(spans.TRUNK) == pytest.approx(4 / units)
    assert s.launches(spans.DC) == pytest.approx(2 / units)
    # gaps: 90-150 at 120 in trunk.block; 700-720 and 760-830 in the conv's
    # backward; 0-40 at 20 in solver.unroll; 350-400 at 375 in
    # trainer.forward; 450-560 in bench.build and 580-660 between backward
    # ops, outside; 850-860 in AccumulateGrad, 870-900 before a kernel with
    # no launch, unmatched; 910-1000 ends the window, outside
    assert s.idle_ms(spans.TRUNK) == pytest.approx(0.150 / units)
    assert s.idle_ms(spans.DC) == 0.0
    assert s.idle_ms(spans.PIPELINE) == 0.0     # not the launching thread
    idle = s.idle_by_span()
    assert idle == pytest.approx({
        "trunk.block": 0.150 / units, "solver.unroll": 0.040 / units,
        "trainer.forward": 0.050 / units, "outside": 0.280 / units,
        "unmatched": 0.040 / units})
    assert s.by_span() == pytest.approx({
        "trunk.block": 0.240 / units, "solver.denoise": 0.050 / units,
        "trunk.head": 0.040 / units, "solver.dc": 0.070 / units,
        "outside": 0.020 / units, "unmatched": 0.020 / units})
    assert s.shares() == pytest.approx({"span": 400 / 4.4, "outside": 20 / 4.4,
                                        "unmatched": 20 / 4.4})


def test_paths_follow_links():
    s = spans.Spans(events(), 1)
    forward = ("trunk.block", "solver.denoise", "solver.unroll",
               "trainer.forward")
    assert s.resolve(MAIN, 135) == (forward, "span")
    # a kernel of the conv's backward: the conv's forward spans
    assert s.resolve(AUTOGRAD, 720) == (forward, "span")
    # the recompute: its own span, then the backward op's forward spans
    assert s.resolve(AUTOGRAD, 650) == (("trunk.head",) + forward, "span")
    assert s.resolve(AUTOGRAD, 825) == (
        ("solver.dc", "solver.unroll", "trainer.forward"), "span")
    assert s.resolve(AUTOGRAD, 860) == ((), "unmatched")
    assert s.resolve(AUTOGRAD, 610) == ((), "outside")
    assert s.resolve(MAIN, 550) == ((), "outside")
    assert s.resolve(OTHER, 400) == (("pipeline.draw",), "span")


class Runner:
    """A runner whose profiled stretch is the hand-made trace."""

    def __init__(self):
        self.profiled = ["kept"]
        self.calls = 0

    def profile_units(self):
        return 2

    def run_units(self, n):
        self.calls += 1
        self.profiled = ["replaced"] * n

    def sync(self):
        pass


class Ctx:
    def __init__(self, trace):
        self.trace, self.runner = trace, Runner()


def test_readers_profile_once_and_read_nothing_without_spans(monkeypatch,
                                                              capsys):
    def fake(fn, sync):
        fn()
        return events()

    monkeypatch.setattr(spans, "profile_events", fake)
    ctx = Ctx(trace=object())
    assert spans.read(ctx, "device_ms", spans.TRUNK) == pytest.approx(0.165)
    assert spans.read(ctx, "launches", spans.TRUNK) == pytest.approx(2.0)
    assert spans.read(ctx, "idle_ms", spans.TRUNK) == pytest.approx(0.075)
    assert spans.read(ctx, "idle_ms", spans.PIPELINE) == 0.0
    # no span of the family in the trace (a program without them): None
    assert spans.read(ctx, "idle_ms", spans.COPIES) is None
    assert spans.read(ctx, "device_ms", spans.RECONSTRUCT) is None
    assert ctx.runner.calls == 1 and ctx.runner.profiled == ["kept"]
    line = capsys.readouterr().err.strip().splitlines()
    assert len(line) == 1 and line[0].startswith("spans ")
    summary = json.loads(line[0][len("spans "):])
    assert summary["device_share"]["span"] == pytest.approx(90.909, 1e-3)
    # off the card: nothing profiled, nothing read
    off = Ctx(trace=None)
    assert spans.read(off, "device_ms", spans.TRUNK) is None
    assert spans.phase_s(off, ("trainer.construct",)) is None
    assert off.runner.calls == 0


def test_phase_readers_take_the_program_table(monkeypatch):
    from dl_swin_gan_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "_PHASES", {"trainer.construct": 1.5,
                                             "trainer.init_state": 7.25})
    ctx = Ctx(trace=object())
    assert spans.phase_s(ctx, ("trainer.construct", "trainer.init_state")) \
        == pytest.approx(8.75)
    assert spans.phase_s(ctx, ("compact.construct",)) is None


def test_new_metrics_listed_last_with_readers():
    """The metrics that read spans come after every other per-layer metric
    (the harness reads them in file order, and their stretch runs after the
    first profile), each with a reader and its cells."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == NEW
    for m in bench["per_layer"][-len(NEW):]:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert m["workloads"]


def test_dry_trace_prints_none_of_the_span_metrics(capsys):
    line = bench_run.main(["--workload", "swin.train_b1", "--seed",
                           "2147483713", "--seconds", "0.5", "--trace", "1",
                           "--device", "cpu"])
    assert line["correct"] is True
    assert not set(NEW) & set(line["metrics"])
    assert "spans " not in capsys.readouterr().err
