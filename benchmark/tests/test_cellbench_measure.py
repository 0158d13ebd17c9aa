"""The statistics and the yardstick: the p95 over every slice, the idle
share as an interval union, the frozen work counts on cases worked by
hand, the stochastic-depth decisions the reference takes from the
program, and the import check."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, trace
from benchmark.reference import nets
from benchmark.runners.serve_compact import Runner as ServeRunner
from benchmark.runners.train import DropRecorder
from benchmark.work import peaks, sense_normal, window_attn


def test_p95_is_over_all_values():
    values = list(range(1, 101))            # 1..100 ms
    assert harness.p95(values) == pytest.approx(95.05)
    assert harness.p95([5.0] * 99 + [500.0]) == pytest.approx(5.0)


def test_serve_window_p95_over_every_slice_inside_the_window():
    """Every request that completed inside the window counts, the slowest
    included; those that completed after it do not."""
    d = ServeRunner.__new__(ServeRunner)
    d.frames = 20
    d.device = type("D", (), {"type": "cpu"})()
    done = [(0.009 * i, 0.009 * i + 0.05 + (0.5 if i == 7 else 0.0), 1.0)
            for i in range(100)]
    done.append((0.99, 1.2, 1.0))           # completes after a 1 s window
    d.loop = lambda seconds: {"done": done, "t0": 0.0}
    out = d.window(1.0)
    inside = [(b - a) * 1e3 for a, b, _ in done[:100]]
    assert out["e2e"]["serve_slice_p95_ms"] == pytest.approx(
        np.percentile(inside, 95))
    assert out["e2e"]["serve_frames_per_s"] == pytest.approx(100 * 20 / 1.0)
    assert out["attempted"] == 101


def test_reference_drops_as_the_program_drew():
    """The keep decisions read at the program's DropPath modules give the
    reference the program's branch outputs: in a forward, and after a
    recompute (whose calls are not kept), on any block of rows."""
    from dl_swin_gan_tpu_torch.models.swin import DropPath

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.drop_path = DropPath(0.5, torch.Generator().manual_seed(7))

        def forward(self, h, m):
            return self.drop_path(h), self.drop_path(m)

    net = torch.nn.Sequential()
    net.add_module("blocks", torch.nn.ModuleList([Block()]))
    net.add_module("idle", DropPath(0.0))
    net.train()
    h, m = torch.randn(16, 3, 4), torch.randn(16, 5)
    h[3] = 0.0
    with DropRecorder(net) as rec:
        out = net.blocks[0](h, m)
        net.blocks[0](h, m)             # a recompute's calls
    keep = rec.decisions()
    assert set(keep) == {"blocks.0.drop_path"}
    dropped = [int((~k).sum()) for k in keep["blocks.0.drop_path"]]
    assert all(0 < d < 16 for d in dropped)
    for rows in (slice(0, 16), slice(4, 9)):
        drops = nets.RecordedDrops(keep, rows)
        for branch, (x, y) in enumerate(zip((h, m), out)):
            got = drops(x[rows], 0.5, "blocks.0", branch)
            torch.testing.assert_close(got, y[rows], rtol=0, atol=0)
        assert drops(h, 0.0, "blocks.9", 0) is h
    with pytest.raises(KeyError):
        nets.RecordedDrops({}, slice(0, 16))(h, 0.5, "blocks.0", 0)


def _events(kernels, window=(0.0, 100.0), host=()):
    ev = [{"ph": "X", "name": "bench.window", "cat": "user_annotation",
           "ts": window[0], "dur": window[1] - window[0]}]
    for name, ts, dur in kernels:
        ev.append({"ph": "X", "name": name, "cat": "kernel", "ts": ts,
                   "dur": dur})
    for name, ts, dur in host:
        ev.append({"ph": "X", "name": name, "cat": "user_annotation",
                   "ts": ts, "dur": dur})
    return ev


def test_idle_share_is_an_interval_union():
    groups = [(20, "conv", "conv"), (40, "elementwise", "elementwise")]
    t = trace.Trace(_events([("conv_a", 10, 20), ("elementwise_b", 20, 20),
                             ("conv_c", 15, 5), ("conv_d", 90, 30)],
                            host=[("bench.draws", 40, 50)]),
                    units=2, groups=groups)
    # [10, 40] and [90, 100] (clipped to the window): 40 of 100 us busy
    assert t.busy_s == pytest.approx(40e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.group_ms("conv") == pytest.approx((20 + 5 + 10) / 1e3 / 2)
    assert t.launches() == 2.0
    idle = t.idle_by_host()
    assert idle["bench.draws"] == pytest.approx(50e-6)
    assert idle["host idle"] == pytest.approx(10e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "conv"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_sense_normal_work_by_hand():
    # B=1, E=1, C=1, T=1, Y=4, X=8, 2 acquired rows
    flops, nbytes = sense_normal.work(1, 1, 4, 8, np.array([[2]]))
    fft4, fft8 = 5 * 4 * 2, 5 * 8 * 3
    expect = (8 * fft4 + 2 * fft8 + 2 * 8 * 2 + 2 * fft8 + 8 * fft4
              + 4 * 8 * 1 * 8 * 2)
    assert flops == expect
    assert nbytes == 2 * 32 * 8 + 32 * 8 + 32 * 4
    rows = sense_normal.acquired(np.array([[[[0, 1], [0, 0], [1, 1]]]]))
    assert rows.tolist() == [[2]]


def test_window_attention_work_by_hand():
    mask = np.zeros((2, 3, 3), np.float32)
    mask[1, 0, 2] = mask[1, 2, 0] = -100.0          # 2 pairs masked
    W, H, N, D = 4, 2, 3, 5
    f, b = window_attn.forward(W, H, N, D, mask)
    pairs = (9 + 7) * 2 * H                         # per nW, times W / nW
    assert f == 2 * 2 * D * pairs
    assert b == 4 * W * H * N * D * 4 + H * N * N * 4 + mask.size * 4
    f0, _ = window_attn.forward(W, H, N, D, None)
    assert f0 == 2 * 2 * D * W * H * N * N
    fb, bb = window_attn.backward(W, H, N, D, None, io_bytes=2)
    assert fb == 2 * f0
    assert bb == 7 * W * H * N * D * 2 + 2 * H * N * N * 4


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12, "float32") == pytest.approx(1.0)
    assert peaks.least_seconds(495e12, 1.0, "float32") == pytest.approx(1.0)


def test_forbidden_names_compared_whole():
    names = ["dl_swin_gan_tpu_torch", "dl_swin_gan_tpu_torch.ops.masks",
             "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(names) == []
    found = harness.forbidden_modules(names + ["dl_swin_gan_tpu.ops",
                                               "jax.numpy", "flax", "jaxlib"])
    assert found == ["dl_swin_gan_tpu.ops", "flax", "jax.numpy", "jaxlib"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_reference_loads_nothing_of_the_program_or_jax():
    names = _loaded(
        "import sys; import benchmark.reference.solver, "
        "benchmark.reference.mri, benchmark.work.model_flops; "
        "print(' '.join(sys.modules))")
    tops = {n.split('.')[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "dl_swin_gan_tpu",
                       "dl_swin_gan_tpu_torch"}


@pytest.mark.parametrize("cell", ["res.train_b16_bf16", "swin.train_b1",
                                  "res.serve_compact"])
def test_a_cell_loads_no_jax(cell):
    """The modules a cell's run loads (its runner's set-up, reference and
    per-layer readers), compared by whole top-level names."""
    names = _loaded(
        "import sys, torch; torch.set_num_threads(1)\n"
        "from benchmark import harness, readers\n"
        f"c = harness.load_cell({cell!r}, dry_run=True)\n"
        "d = harness.load_runner(c.traffic['runner'])(\n"
        "    c, torch.device('cpu'), 3)\n"
        "d.setup()\n"
        "[readers.load_reader(n) for n in c.per_layer()]\n"
        "print(' '.join(sys.modules))")
    assert harness.forbidden_modules(names) == []
    assert "dl_swin_gan_tpu_torch" in {n.split(".")[0] for n in names}
