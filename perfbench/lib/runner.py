"""One run of one cell: set-up, the measured window, the reading of the
device's peak memory, the program's state freed, the comparison that
decides ``correct``, and the metrics."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Optional

from . import env, judge, spec
from .trace import Trace, profiled

__all__ = ["Run", "run_cell"]


@dataclasses.dataclass
class Run:
    """What a run holds: its cell, seed and device, the program's state
    (``state``, freed by the driver's ``release``), the window's records
    and, in a traced run, the device trace."""

    cell: spec.Cell
    seed: int
    device: Any
    state: dict = dataclasses.field(default_factory=dict)
    records: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    trace: Optional[Trace] = None

    @property
    def model(self) -> dict:
        """The configuration as the port runs it (``port_config``)."""
        return self.cell.config["port_config"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


def _metric(entry: dict, value: float) -> dict:
    return {"value": float(value), "unit": entry["unit"]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", require_chip: bool = True,
             overrides: Optional[dict] = None) -> dict:
    """Run ``workload`` once and return its result line as a dict.
    ``t0`` is the host clock at the process's start (set-up counts from
    it). ``require_chip=False`` skips the look for a chip, and
    ``overrides`` cut the cell to a test's size (:func:`spec.cell`)."""
    import torch
    cell = spec.cell(workload, overrides)
    if require_chip:
        env.require_chips(cell.chips)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver = spec.kind(cell.traffic["kind"])
    run = Run(cell=cell, seed=int(seed), device=dev)
    driver.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t0
    with profiled(trace) as holder:
        driver.window(run, seconds)
    run.trace = holder.trace
    record = env.device_record(dev, cell.chips)
    if trace:
        metrics = {}
        for entry in cell.per_layer:
            value = spec.metric_reader(entry["name"]).read(run)
            if value is not None:
                metrics[entry["name"]] = _metric(entry, value)
        record["busy_s"] = run.trace.busy_s
        record["window_s"] = run.trace.window_s
    else:
        values = {"setup_s": run.setup_s, **driver.end_to_end(run)}
        metrics = {e["name"]: _metric(e, values[e["name"]])
                   for e in cell.end_to_end}
    driver.release(run)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge.verdict(driver.judge(run, "f32"), cell.limits)
    correct = run.failed == 0 and all(
        judge.passed(c["value"], c["limit"]) for c in checks.values())
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": record}
    if trace:
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = checks
    return out
