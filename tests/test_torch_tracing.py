"""The port's spans and set-up phases (`utils/tracing.py`), on the CPU at toy
shapes: with no profiler a span enters no `record_function` and a train
step is bitwise the same with spans stubbed out; under
`torch.profiler.profile` the train step, the hqs and dc rules and a
compact serving call emit their span trees; `phases()` times set-up; fit's
`Train/steps_per_sec` leaves out the loop's other work."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.infer import compact
from dl_swin_gan_tpu_torch.solvers import build_solver
from dl_swin_gan_tpu_torch.train import Trainer
from dl_swin_gan_tpu_torch.utils import tracing

torch.set_num_threads(1)

T, Y, X, C, E = 6, 16, 12, 3, 2
UNROLLS = 2


def _cfg(meta="dlespirit", remat=False):
    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "RES"
    cfg.MODEL.META_ARCHITECTURE = meta
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = UNROLLS
    p.NUM_RESBLOCKS = 1
    p.NUM_FEATURES = 4
    p.NUM_EMAPS = E
    p.MODL.NUM_CG_STEPS = 2
    p.GRAD_CHECKPOINT = remat
    p.CONV_BLOCK.COMPLEX = False
    cfg.OUTPUT_DIR = "runs/test_tracing"
    return cfg


def _batch(B=1, seed=0):
    """A train batch of B toy examples, numpy, the trainer's keys."""
    rng = np.random.RandomState(seed)
    kspace, maps, target = [], [], []
    for b in range(B):
        k, m, t = make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=seed + b)
        kspace.append(k)
        maps.append(m)
        target.append(t)
    mask = (rng.rand(B, 1, T, Y, X) < 0.5).astype(np.float32)
    kspace = (np.stack(kspace) * mask).astype(np.complex64)
    target = np.stack(target).astype(np.complex64)
    return dict(kspace=kspace, maps=np.stack(maps).astype(np.complex64),
                mask=mask, init_image=target * 0.5,
                scale=np.ones((B,), np.float32), target=target)


def _step(batch, remat=False):
    """One seeded train step: (loss, {name: gradient})."""
    trainer = Trainer(_cfg(remat=remat), device="cpu")
    state = trainer.init_state(seed=3)
    metrics = trainer.train_step(state, batch)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if p.grad is not None}
    return metrics[trainer.train_metric].clone(), grads


def _spans(prof):
    """(name, start, end) of the program's spans in a finished profile."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.split(".")[0] in tracing.LAYERS and "." in e.name]


def _inside(spans, inner, outer):
    """How many `inner` spans lie inside some `outer` span."""
    outs = [(a, b) for n, a, b in spans if n == outer]
    return sum(1 for n, a, b in spans if n == inner
               and any(oa <= a and b <= ob for oa, ob in outs))


def test_off_enters_no_record_function(monkeypatch):
    """No profiler: one shared null context, and record_function is never
    built."""
    assert not torch.autograd.profiler._is_profiler_enabled

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a = tracing.span("solver.unroll")
    b = tracing.span("trunk.block")
    assert a is b
    with a:
        pass
    _step(_batch())


def test_spans_change_no_number(monkeypatch):
    """The RES pgd train step (remat on) gives bitwise the same loss and
    gradients with the spans as with `span` stubbed out, profiler on and
    off."""
    batch = _batch(B=2)
    ref_loss, ref_grads = _step(batch, remat=True)
    with profile(activities=[ProfilerActivity.CPU]):
        on_loss, on_grads = _step(batch, remat=True)
    monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
    for mod in ("solvers.unrolled", "models.resnet", "train.trainer"):
        module = __import__(f"dl_swin_gan_tpu_torch.{mod}",
                            fromlist=["span"])
        monkeypatch.setattr(module, "span", tracing.span)
    with profile(activities=[ProfilerActivity.CPU]):
        stub_loss, stub_grads = _step(batch, remat=True)
    for loss, grads in ((on_loss, on_grads), (stub_loss, stub_grads)):
        assert torch.equal(loss, ref_loss)
        assert grads.keys() == ref_grads.keys()
        for n in ref_grads:
            assert torch.equal(grads[n], ref_grads[n]), n


def test_train_step_span_tree():
    """Under the profiler the step emits trainer.* around the solver's
    tree: an init, then per unroll a solver.unroll holding solver.dc and
    solver.denoise, the trunk's head, block and tail in each denoise."""
    batch = _batch()
    trainer = Trainer(_cfg(), device="cpu")
    state = trainer.init_state(seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, batch)
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    for name in ("trainer.to_device", "trainer.forward", "trainer.loss",
                 "trainer.backward", "trainer.optimizer"):
        assert names.count(name) == 1, name
    assert "trainer.ema" not in names      # no EMA in this trainer
    assert _inside(spans, "solver.init", "trainer.forward") == 1
    assert _inside(spans, "solver.unroll", "trainer.forward") == UNROLLS
    for inner in ("solver.dc", "solver.denoise"):
        assert names.count(inner) == UNROLLS
        assert _inside(spans, inner, "solver.unroll") == UNROLLS
    for part, n in (("trunk.head", 1), ("trunk.block", 1), ("trunk.tail", 1)):
        assert _inside(spans, part, "solver.denoise") == n * UNROLLS, part


@pytest.mark.parametrize("meta", ["modl", "ddpm_x"])
def test_hqs_and_dc_rules_span_tree(meta):
    """The hqs (CG) and dc rules: per unroll a denoise, then the rule's
    solver.dc, both in solver.unroll."""
    torch.manual_seed(0)
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model = build_solver(_cfg(meta), torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(b["kspace"], b["maps"], b["mask"], x0=b["init_image"])
    spans = _spans(prof)
    for inner in ("solver.dc", "solver.denoise"):
        assert _inside(spans, inner, "solver.unroll") == UNROLLS, inner
    order = [n for n, _, _ in sorted(spans, key=lambda s: s[1])
             if n in ("solver.dc", "solver.denoise")]
    assert order == ["solver.denoise", "solver.dc"] * UNROLLS


def test_compact_call_span_tree():
    """One CompactReconstructor call over the flat wire: the upload, the
    reconstruction (decode, normalize, init and the solver inside it) and
    the read-back."""
    cfg = _cfg()
    cfg.MODEL.PARAMETERS.SLWIN_INIT = True
    kspace, maps, _ = make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=0)
    transform = compact.CompactTransform(cfg, acceleration=3.0)
    example = compact.pad_lines(transform(kspace, maps), 8)
    wire = compact.FlatWire(example)
    buf = wire.encode(example)[None]
    rec = compact.CompactReconstructor(cfg, None, ny=Y, wire=wire,
                                       device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        image = rec(buf)
    assert image.shape == (1, E, T, Y, X)
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    for name in ("compact.upload", "compact.reconstruct", "compact.readback"):
        assert names.count(name) == 1, name
    for inner in ("compact.decode", "compact.normalize", "compact.init",
                  "solver.init"):
        assert _inside(spans, inner, "compact.reconstruct") == 1, inner
    assert _inside(spans, "solver.unroll", "compact.reconstruct") == UNROLLS
    assert _inside(spans, "compact.readback", "compact.reconstruct") == 0


def test_phases_time_set_up():
    """phases() adds the host seconds of Trainer construction and
    init_state; a phase is a span under the profiler."""
    before = tracing.phases()
    trainer = Trainer(_cfg(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.init_state(seed=0)
    after = tracing.phases()
    for name in ("trainer.construct", "trainer.init_state"):
        assert after[name] > before.get(name, 0.0), name
    assert [n for n, _, _ in _spans(prof)] == ["trainer.init_state"]
    with tracing.phase("kernels.build") as timer:
        pass
    assert timer.seconds >= 0.0
    assert tracing.phases()["kernels.build"] >= timer.seconds


def test_steps_per_sec_counts_train_steps_only(monkeypatch):
    """fit's Train/steps_per_sec: the steps since the last log over their
    time, less what the loop spent paused (checkpoints, validation, image
    logging, the trace's export)."""
    from dl_swin_gan_tpu_torch.train import trainer as trainer_module

    clock = [100.0]
    monkeypatch.setattr(trainer_module.time, "perf_counter",
                        lambda: clock[0])
    rate = trainer_module._StepRate()
    for _ in range(4):                  # 4 steps of 0.5 s
        clock[0] += 0.5
        rate.steps += 1
    with rate.paused():                 # a 3 s checkpoint
        clock[0] += 3.0
    assert rate.take() == pytest.approx(2.0)
    clock[0] += 1.0                     # the next interval starts afresh
    rate.steps += 1
    with rate.paused():
        clock[0] += 7.0                 # a validation
    assert rate.take() == pytest.approx(1.0)
