"""The manifest against the benchmark's contract, every file found by its
name, and the yardstick's operation and byte counts."""

import json
import os
import re

import pytest

from benchmark import check, harness, traffic, work

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = harness.manifest()


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in MAN["paths"])
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("benchmark/configs/")
    assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200
    assert entry["source"].startswith("https://")
    cfg = harness.load_config(entry)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert entry["reduced"] == []
    assert any(c["config"] == entry["name"] for c in MAN["workloads"])
    assert os.path.exists(os.path.join(harness.HERE, "reference", f"{cfg['reference']}.py"))
    fe = cfg["front_end"]
    assert fe["bands"] * fe["dct_bases"] == cfg["dims"][0]


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    mix = traffic.load(cell["traffic"])
    assert mix["kind"] in ("resident", "stream") and mix["trace_seconds"] > 0
    assert set(check.load_limits(cell["name"])) >= set(check.NUMBERS)
    e2e = harness.cell_metrics(MAN, cell["name"], False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.cell_metrics(MAN, cell["name"], True)


def test_pairs_and_names_unique():
    pairs = [(c["config"], c["traffic"]) for c in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = harness.metric_module(metric["name"])
    assert mod.UNIT == metric["unit"] and callable(mod.read)
    cells = {c["name"] for c in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert mod.MOVES == metric["moves"]
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
    assert any("mfu" in m["name"] for m in MAN["per_layer"])


@pytest.mark.parametrize("name", ["prod_tnetcu", "prod_tnet_sgd"])
def test_operation_and_byte_counts(name):
    cfg = harness.load_config(next(c for c in MAN["configs"] if c["name"] == name))
    c = work.counts(cfg)
    assert c["params"] == 88_080_384 + 24_576
    # forward and weight gradient 2·ΣIn·Out each, input gradients of layers 2-5
    assert c["flops_per_frame"] == 2 * 2 * 88_080_384 + 2 * (3 * 4096 ** 2 + 4096 * 8192)
    assert c["flops_per_frame"] == pytest.approx(520.09e6, rel=1e-5)
    # the four hidden forwards and five weight gradients at 165 TFLOP/s
    assert c["affine_sigmoid_bound_us"] == pytest.approx(676.78, abs=0.01)
    assert c["wgrad_momentum_bound_us"] == pytest.approx(1093.26, abs=0.01)
    assert work.peak(cfg) == pytest.approx(165e12)


def test_bytes_bound_a_thin_layer():
    cfg = {"dims": [4, 8192], "bunch": 1, "compute": "f32"}
    # 1 x 4 -> 8192: the weight's bytes, not its 65,536 operations, bound it
    want = 4 * (4 + 4 * 8192 + 8192 + 8192) / work.HBM_BYTES_S
    assert work.bound_s(2 * 4 * 8192, 4 * (4 + 4 * 8192 + 8192 + 8192), cfg) == want


def test_traffic_files_are_data():
    for name in {c["traffic"] for c in MAN["workloads"]}:
        with open(os.path.join(harness.HERE, "traffic", f"{name}.json")) as f:
            json.load(f)


def test_the_streamed_mix_kept_for_later_is_whole():
    """Adding the streamed cell takes entries in BENCHMARK.json alone: its
    mix, its limits and its intake metric's reader are here."""
    assert traffic.load("stream")["kind"] == "stream"
    assert set(check.load_limits("prod_tnetcu.stream")) >= set(check.NUMBERS)
    assert harness.metric_module("intake_wait_share").MOVES == "train_fps"
