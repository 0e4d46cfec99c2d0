"""The benchmark is driven by data: every cell, configuration, traffic
mix, limit file, reference and metric reader is found by name, and
BENCHMARK.json keeps to its contract's shapes."""

import json
import re

import pytest

from perfbench.lib import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for entry in BENCH["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in entry["reduced"])
        names.append(entry["name"])
    for entry in BENCH["workloads"]:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] == 1
        assert len(entry["why"]) <= 200
        names += [entry["name"], entry["traffic"]]
    for entry in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        names.append(entry["name"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert len(group_names) == len(set(group_names))


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.traffic["kind"] in ("tune", "generate", "decode")
    spec.kind(cell.traffic["kind"])
    spec.reference(cell.config["reference"])
    assert cell.limits
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert metric["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    reader = spec.metric_reader(metric)
    assert callable(reader.read)


def test_configs_hold_what_runs():
    for entry in BENCH["configs"]:
        with open(spec.ROOT / entry["file"], encoding="utf-8") as f:
            conf = json.load(f)
        assert conf["name"] == entry["name"]
        assert conf["source"] == entry["source"]
        assert conf["reduced"] == entry["reduced"]
        assert set(conf["source_values"]) == set(entry["reduced"])
        for key in entry["reduced"]:
            assert conf[key] != conf["source_values"][key]
        from repro_torch.models.config import ModelConfig
        ModelConfig(**conf["port_config"])
