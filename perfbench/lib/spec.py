"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration, whose entry
in ``configs`` gives its file, and its traffic mix, which is the file
``perfbench/traffic/<traffic>.json``. The traffic file's ``kind`` names
the driver that runs it (``perfbench/lib/kinds/<kind>.py``); the
configuration file's ``reference`` names its plain reference
(``perfbench/reference/<reference>.py``); each per-layer metric is read
by ``perfbench/metrics/<name>.py``. Adding a cell takes new files and
one ``workloads`` entry, and no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Optional

__all__ = ["BENCH_DIR", "Cell", "ROOT", "cell", "kind", "load",
           "metric_reader", "reference", "reported"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it is made of."""

    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    end_to_end: list        # the end-to-end metrics this cell reports
    per_layer: list         # the per-layer metrics this cell reports
    limits: dict            # each number deciding ``correct``: its limit


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def reported(metric: dict, workload: str, end_to_end: list) -> bool:
    """Whether ``workload`` reports ``metric``: the cells its
    ``workloads`` key lists, or, without the key, every cell (an
    end-to-end metric) or every cell that reports the end-to-end metric
    it moves (a per-layer metric)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in end_to_end if m["name"] == moves)
    return reported(target, workload, end_to_end)


def cell(name: str, overrides: Optional[dict] = None,
         root: Path = ROOT) -> Cell:
    """The cell ``name``. ``overrides`` ({"config": {...}, "port_config":
    {...}, "traffic": {...}, "limits": {...}}) replaces entries of its
    configuration file, of that file's ``port_config``, of its traffic
    and of its limits (``perfbench/limits/<cell>.json``): the CPU tests
    run a cell at a size a test can hold, with limits set from readings
    at that size."""
    bench = load(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        known = [w["name"] for w in bench["workloads"]]
        raise KeyError(f"unknown workload {name!r}; known: {known}")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    with open(root / conf["file"], encoding="utf-8") as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{work['traffic']}.json",
              encoding="utf-8") as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "limits" / f"{name}.json",
              encoding="utf-8") as f:
        limits = json.load(f)["limits"]
    for key, part in (("config", config), ("port_config",
                                            config["port_config"]),
                      ("traffic", traffic), ("limits", limits)):
        part.update((overrides or {}).get(key, {}))
    e2e = bench["end_to_end"]
    return Cell(name=name, chips=int(work["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in e2e if reported(m, name, e2e)],
                per_layer=[m for m in bench["per_layer"]
                           if reported(m, name, e2e)],
                limits={k: float(v) for k, v in limits.items()})


def _load_file(path: Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``: the module
    ``perfbench/metrics/<name>.py``, whose ``read(run)`` returns the
    metric's value, or None where the run holds nothing to read."""
    safe = name.replace(".", "_").replace("-", "_")
    return _load_file(BENCH_DIR / "metrics" / f"{name}.py",
                      f"perfbench_metric_{safe}")


def kind(name: str) -> ModuleType:
    """The driver of a traffic file's ``kind``."""
    return importlib.import_module(f"perfbench.lib.kinds.{name}")


def reference(name: str) -> ModuleType:
    """A configuration's plain reference."""
    return importlib.import_module(f"perfbench.reference.{name}")
