"""BENCHMARK.json against the benchmark's contract, and the registry: every
name resolves to its file, and a new configuration, traffic mix and metric
are found from their files and entries alone."""

import json
import re
import shutil
import time

import pytest

from benchmark import run, spec, trace

from .conftest import CELLS, UNLISTED, any_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_json(spec.BENCHMARK_JSON)
E2E = {m["name"] for m in BENCH["end_to_end"]}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = spec.load_json(spec.ROOT / c["file"])
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert c["reduced"] == [] and c["name"] in used


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in E2E and _line(m["layer"])
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", CELLS)
def test_every_name_resolves(name):
    cell = spec.cell(name)
    assert {m["name"] for m in cell.end_to_end} == E2E
    assert cell.per_layer
    query = spec.load_module("queries", cell.traffic["query"])
    for fn in ("make_call", "work", "least_s", "readings"):
        assert callable(getattr(query, fn))
    for m in cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert set(cell.traffic["check"]["limits"])


@pytest.mark.parametrize("name", UNLISTED)
def test_unlisted_mixes_resolve(name):
    cell = any_cell(name)
    assert name not in CELLS
    assert spec.load_module("queries", cell.traffic["query"]).readings
    assert set(cell.traffic["check"]["limits"])


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        spec.cell("hull24_16k.nothing")


NEW_METRIC = '''"""Calls in the traced sub-window."""


def read(view):
    return float(view.calls)
'''


def test_new_files_and_entries_are_picked_up(tmp_path, cpu):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, in a copy of the benchmark, run with no other edit."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "hull8_small", "source": "a test",
                             "file": "benchmark/configs/hull8_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "hull8_small.near", "chips": 1,
                               "config": "hull8_small", "traffic": "near",
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["hull8_small.near"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    config = spec.load_json(spec.HERE / "configs" / "hull64_64k.json")
    config.update(name="hull8_small", pairs=128, vertices=[8, 8], pool=2)
    (tmp_path / "benchmark/configs/hull8_small.json").write_text(
        json.dumps(config))
    traffic = spec.load_json(spec.HERE / "traffic" / "overlap.json")
    traffic["sides"] = [{"scale": 1.0, "offset_sd": 0.5}] * 2
    (tmp_path / "benchmark/traffic/near.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/metrics/calls_traced.py").write_text(NEW_METRIC)

    cell = spec.cell("hull8_small.near", root=tmp_path)
    assert cell.config["vertices"] == [8, 8]
    assert [m["name"] for m in cell.per_layer] == ["calls_traced"]
    result, _ = run.run_cell(cell, 7, 0.2, True, cpu, time.perf_counter(),
                             lambda msg: None, traced_calls=2)
    assert result["metrics"] == {"calls_traced": {"value": 2.0,
                                                  "unit": "calls"}}
    assert result["correct"] is True


def test_program_kernels():
    names = trace.program_kernels()
    assert {"gjk_hulls_kernel", "epa_hulls_kernel",
            "distance_hulls_kernel", "epa_polish_kernel"} <= names

