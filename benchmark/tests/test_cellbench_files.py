"""BENCHMARK.json against the contract, and every file the harness finds by
name: each configuration, cell, group and metric reader."""

import json
import re

import pytest

from benchmark import harness, readers, trace

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert "setup_s" in names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    runner = harness.load_runner(c.traffic["runner"])
    assert callable(runner.reference) and callable(runner.window)
    assert set(c.traffic["limits"])
    assert "setup_s" in c.end_to_end() and len(c.end_to_end()) >= 2
    assert c.per_layer()
    for name in c.per_layer():
        assert callable(readers.load_reader(name))
        # every metric a cell lists reports that cell's end-to-end metric
        assert c.metrics[name]["moves"] in c.end_to_end()
    cfg = harness.program_cfg(c)
    assert cfg.MODEL.PARAMETERS.NUM_UNROLLS == c.spec["num_unrolls"]
    assert harness.trunk_precision(cfg) in harness.CONTROL_BELOW


@pytest.mark.parametrize("cell,trunk,control", [
    ("res.train_b16_bf16", "bfloat16", "fp8"),
    ("swin.train_b1", "float32", "tf32"),
    ("res.serve_compact", "float32", "tf32")])
def test_precision_comes_from_the_configuration(cell, trunk, control):
    """The reference's precision is the one the configuration states for
    the trunk, and the control one below it."""
    cfg = harness.program_cfg(harness.load_cell(cell))
    assert harness.trunk_precision(cfg) == trunk
    assert harness.CONTROL_BELOW[trunk] == control


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_its_yaml(conf):
    """The configuration's file holds what the repo YAML it names sets, at
    the published widths; only the keys its `reduced` lists depart from
    the YAML, and none of them is a width."""
    yaml = pytest.importorskip("yaml")
    from dl_swin_gan_tpu_torch.config import get_cfg

    data = harness.load_json(harness.ROOT / conf["file"])
    reduced = conf["reduced"]
    assert reduced == data["reduced"] and len(reduced) <= 16
    for key in reduced:
        assert NAME.match(key) and key in data["cfg"]
        assert not re.search(r"FEATURES|_DIM|_RANK|HEADS|RATIO", key)
    with open(harness.ROOT / data["yaml"]) as f:
        raw = yaml.safe_load(f)
    cfg = get_cfg()
    cfg.merge_from_file(str(harness.ROOT / data["yaml"]))

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}"

    assert sorted(set(flat(raw)) | set(reduced)) == sorted(data["cfg"])
    for key, value in data["cfg"].items():
        if key in reduced:
            continue
        node = cfg
        for part in key.split("."):
            node = node[part]
        assert json.loads(json.dumps(node if not isinstance(node, tuple)
                                     else list(node))) == value, key


def test_every_metric_has_a_reader_and_groups_load():
    for m in BENCH["per_layer"]:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    groups = trace.load_groups()
    names = {g for _, _, g in groups}
    for needed in ("conv", "conv_transpose", "gemm", "adam", "elementwise",
                   "sense_normal", "window_attn_fwd", "window_attn_bwd"):
        assert needed in names


def test_group_rank_then_longest_pattern():
    groups = [(20, "fprop", "conv"), (30, "gemm", "gemm"),
              (10, "nchwtonhwc", "conv_transpose"), (5, "attn_bwd", "bwd"),
              (5, "window_attn_fwd", "fwd"), (30, "gemm_long", "gemm2")]
    assert trace.group_of("sm90_xmma_fprop_implicit_gemm_bf16", groups) \
        == "conv"
    assert trace.group_of("cudnn::nchwToNhwcKernel", groups) \
        == "conv_transpose"
    assert trace.group_of("attn_bwd_kv_kernel<20>", groups) == "bwd"
    assert trace.group_of("cutlass_gemm_long_tn", groups) == "gemm2"
    assert trace.group_of("vectorized_elementwise_kernel", groups) == "other"
