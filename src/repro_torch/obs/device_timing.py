"""Optional on-device timing via ``torch.profiler``.

Host clock brackets (what the samplers measure) include the wrapper's
dispatch, the launch and the synchronize's wake-up on top of the
kernel's device-side busy time. :func:`profile_sample` runs one
sample inside a ``torch.profiler`` window (CPU and CUDA activity),
exports the window as a Chrome trace, sums the durations of its CUDA
kernel events (``cat == "kernel"``: cuBLAS kernels and the port's
ctypes-launched kernels alike) and reports the host-vs-device skew —
the direct measurement of what the host brackets miss.

The host bracket is the recorded call itself: the sample plus a
``torch.cuda.synchronize`` (the counterpart of ``block_until_ready``),
timed inside the profiler window, so the profiler's own start and stop
and the window's throwaway kernels are not charged to it.

Caveats, all by design:

- a profiled invocation is *slower* than an unprofiled one (the trace
  collector adds overhead to every launch), so the evaluator only
  profiles incumbent-candidate trials, never the measured samples;
- on the host (``device="cpu"`` work, or a torch without CUDA) there is
  no kernel track, so both functions return ``None`` — callers degrade
  to host timing;
- the tracer drops kernel records while it starts up (torch 2.11 on
  an H100: a window's first launches, more the older the process) and,
  in a long window, some early records of a recorded step, so each
  window is a ``torch.profiler`` schedule of one warm-up step, in which
  the tracer starts, and one recorded step; each opens with a
  :data:`GUARD_S` hold of the card and :data:`PRIMER` throwaway kernels,
  and the sample then runs inside a ``record_function`` range whose
  kernels are picked out by their launches' correlation ids, the window
  closing :data:`GUARD_S` after it; launches of the range left without
  a kernel record are counted in the ``device_timing.lost_kernel_records``
  metric, and an error names their order and time in the range;
- **no fallback on the card**: when any launch of the sample has no
  kernel record, :class:`DeviceTimingError` is raised — ``None`` is
  never returned for work that ran on the card, and a partial sum never
  stands in for the device time;
- a :class:`~repro_torch.core.card_clock.CardClock` sample may take
  several tries (the profiler slows the host's queueing past the hold),
  each in a :data:`~repro_torch.core.card_clock.TRY_MARK` range: only the
  last try's kernels count, and not the spin kernel holding the stream
  (its launch lies in a :data:`~repro_torch.core.card_clock.HOLD_MARK`
  range);
- overlapping kernel events (several streams) are summed, not unioned,
  so the busy time is an upper bound on wall occupancy.

**Per-op join.** :func:`profile_ops` also charges each kernel of the
sample to the op that launched it, for the roofline attribution
(:mod:`repro_torch.obs.attribution`). The sample runs under
:class:`~repro_torch.analysis.ops.OpCounter` with ``mark=True``, which
opens a ``record_function`` range named by each op's ``<op>#<k>`` key
around the op; a kernel's launch call (found through its
``correlation`` id) lies in one such range on its thread, and the
kernel's time goes to that key (``DeviceOps.by_op``), the key
:func:`~repro_torch.analysis.ops.count_ops` gives the op. Counting and
measuring one and the same eager call makes the join exact: a join by
the profiler's own op events, by name and occurrence, drifts in the
backward pass, where autograd accumulates gradients out of place under
a dispatch mode and in place without one, and where one op name has
both composite and kernel overloads. Kernels launched outside every
range are in ``total_s`` and in no key.

Profiling is serialized by a process-wide lock: one profiler session
may run at a time.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional

from ..core.card_clock import HOLD_MARK, TRY_MARK
from .metrics import metrics

__all__ = ["DeviceOps", "DeviceTiming", "DeviceTimingError",
           "device_timing_available", "normalize_op_name", "parse_trace",
           "profile_ops", "profile_sample"]

TRACE_FILE = "torch_trace.json"
#: the ``record_function`` range of the measured call in a window
MARK = "repro_torch.device_timing.sample"
#: Throwaway kernels that open every profiler window on the card. On an
#: H100 with torch 2.11 a window loses the kernel records of its first
#: launches (the launch calls are recorded), and their count grows with
#: the process's age: none in a fresh process, 14 a window after three
#: minutes of GPU work (``python -m repro_torch.bench.sampler_probe``).
#: The sample's own launches come after these.
PRIMER = 256
#: Seconds of guard on each side of the sample inside the recorded step:
#: the step opens with a spin kernel (``torch.cuda._sleep``) holding the
#: card at least this long before the primer, and closes this long after
#: the sample's synchronize, so that the sample's kernels lie well inside
#: the tracer's capture window at both ends. The cause of the losses is
#: not established; their growth with the process's age fits device
#: timestamps drifting against the host's clock, which a time guard
#: covers and a count of kernels may not (a 16582-launch window lost one
#: record after ten minutes of GPU work with the primer alone).
GUARD_S = 0.05
#: ``torch.cuda._sleep`` cycles for :data:`GUARD_S` at an SM clock of up
#: to 2 GHz (the H100's maximum is 1.98 GHz; slower clocks hold longer)
_GUARD_CYCLES = int(GUARD_S * 2.0e9)
_PROFILE_LOCK = threading.Lock()


class DeviceTimingError(RuntimeError):
    """Work ran on the card but the profiler recorded no kernel event."""


@dataclasses.dataclass(frozen=True)
class DeviceTiming:
    """One profiled invocation: device busy time vs the host bracket."""

    device_time_s: float
    host_time_s: float
    skew_s: float  # host bracket minus device busy time
    n_events: int
    source: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DeviceOps:
    """Per-kernel device busy time of one profiled invocation.

    ``by_name`` keys are kernel names (``triad_vec_kernel``, a cuBLAS
    ``sm90_…gemm…`` name): the demangled signature's return type,
    template arguments and parameter list stripped; events under one name
    are summed.
    """

    total_s: float
    by_name: dict[str, float]
    n_events: int
    source: str
    #: device time per launching op, keyed ``<op>#<k>`` (the per-op join)
    by_op: dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def device_timing_available() -> bool:
    """True when a card is visible, so the profiler window records CUDA
    activity (whether it does is then checked on every trace)."""
    try:
        import torch
        return torch.cuda.is_available()
    except Exception:
        return False


def normalize_op_name(name: str) -> str:
    """Kernel event name -> kernel name: ``void ns::k<f32, 64>(float*,
    ...)`` -> ``ns::k``; names without a signature pass through."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


#: a per-op range's name: ``<namespace>::<op>#<occurrence>``
_OP_KEY = re.compile(r"^\w+::\w+#\d+$")


def _op_join(complete: list, kernels: list, launches: list,
             ranges) -> dict[str, float]:
    """Device seconds of ``kernels`` per launching op: each kernel to the
    innermost ``<op>#<k>`` range (see the module docstring) enclosing its
    launch on the launch's thread, inside ``ranges``."""
    keyed = [(ev.get("tid"), float(ev["ts"]),
              float(ev["ts"]) + float(ev["dur"]), str(ev["name"]))
             for ev in complete
             if str(ev.get("cat", "")).lower() == "user_annotation"
             and _OP_KEY.match(str(ev.get("name", "")))
             and _inside(ev, ranges)]
    launch_at = {(ev.get("args") or {}).get("correlation"):
                 (ev.get("tid"), float(ev["ts"])) for ev in launches}
    out: dict[str, float] = {}
    for kern in kernels:
        where = launch_at.get((kern.get("args") or {}).get("correlation"))
        if where is None:
            continue
        tid, t = where
        around = [(hi - lo, key) for ktid, lo, hi, key in keyed
                  if ktid == tid and lo <= t <= hi]
        if around:
            key = min(around)[1]
            out[key] = out.get(key, 0.0) + float(kern.get("dur", 0.0)) * 1e-6
    return out


def _is_launch(event: dict) -> bool:
    cat = str(event.get("cat", "")).lower()
    return (cat in ("cuda_runtime", "cuda_driver")
            and "launch" in str(event.get("name", "")).lower())


def _ranges(complete: list, name: str) -> list[tuple[float, float]]:
    return [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            for ev in complete if ev.get("name") == name
            and str(ev.get("cat", "")).lower() == "user_annotation"]


def _inside(ev: dict, ranges) -> bool:
    return any(lo <= float(ev["ts"]) <= hi for lo, hi in ranges)


def parse_trace(doc: dict, source: str = "", mark: Optional[str] = None,
                ) -> Optional[DeviceOps]:
    """Sum the CUDA kernel events of one exported ``torch.profiler``
    Chrome trace. With ``mark``, only the kernels launched inside the
    host ranges so named (``record_function``) count: a kernel belongs to
    the runtime or driver launch call with its ``correlation`` id, and
    every launch in the ranges must have its kernel. Where a
    :class:`~repro_torch.core.card_clock.CardClock`'s tries lie in them
    (:data:`~repro_torch.core.card_clock.TRY_MARK` ranges), only the
    launches of the last try count, and not its hold
    (:data:`~repro_torch.core.card_clock.HOLD_MARK`). ``None`` when the
    trace holds neither a kernel nor a CUDA launch (host-only work);
    raises :class:`DeviceTimingError` when it holds a launch but no
    kernel, or, with ``mark``, when any launch in the ranges has none."""
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("not a Chrome trace: no traceEvents list")
    complete = [ev for ev in events
                if isinstance(ev, dict) and ev.get("ph") == "X"]
    cats: dict[str, int] = {}
    for ev in complete:
        cat = str(ev.get("cat", ""))
        cats[cat] = cats.get(cat, 0) + 1
    launches = [ev for ev in complete if _is_launch(ev)]
    kernels = [ev for ev in complete
               if str(ev.get("cat", "")).lower() == "kernel"]
    if mark is not None:
        ranges = _ranges(complete, mark)
        if not ranges:
            raise ValueError(f"trace holds no {mark!r} range")
        tries = [r for r in _ranges(complete, TRY_MARK)
                 if any(lo <= r[0] <= hi for lo, hi in ranges)]
        if tries:
            ranges = [max(tries)]
        held = _ranges(complete, HOLD_MARK)
        launches = [ev for ev in launches if _inside(ev, ranges)
                    and not _inside(ev, held)]
        ids = [(ev.get("args") or {}).get("correlation") for ev in launches]
        kernels = [ev for ev in kernels
                   if (ev.get("args") or {}).get("correlation") in ids]
        found = {(ev.get("args") or {}).get("correlation") for ev in kernels}
        missing = [i for i in ids if i is None or i not in found]
        if kernels and missing:
            lost = set(missing)
            start = min(lo for lo, _ in ranges)
            order = sorted(launches, key=lambda ev: float(ev["ts"]))
            where = [f"#{k} at {(float(ev['ts']) - start) * 1e-3:.3f} ms"
                     for k, ev in enumerate(order)
                     if (ev.get("args") or {}).get("correlation") in lost]
            span = sum(hi - lo for lo, hi in ranges) * 1e-3
            raise DeviceTimingError(
                f"{len(missing)} of the {len(ids)} launches in the {mark!r} "
                f"range have no kernel event ({source or 'trace'}; "
                f"correlation ids {missing}; launch order and time into the "
                f"range {where[:10]} of {span:.3f} ms): the device time "
                f"would be short")
    if not kernels:
        if launches:
            raise DeviceTimingError(
                "the profiled work launched CUDA kernels but the profiler "
                f"recorded no kernel event ({source or 'trace'}: complete "
                f"events by category {cats}); device timing is unavailable "
                "on this card")
        return None
    by_name: dict[str, float] = {}
    for ev in kernels:
        key = normalize_op_name(str(ev.get("name", "")))
        by_name[key] = by_name.get(key, 0.0) + float(ev.get("dur", 0.0)) * 1e-6
    total_us = sum(float(ev.get("dur", 0.0)) for ev in kernels)
    by_op = _op_join(complete, kernels, launches, ranges) \
        if mark is not None else {}
    return DeviceOps(total_s=total_us * 1e-6, by_name=by_name,
                     n_events=len(kernels), source=source, by_op=by_op)


def _lost_records(doc: dict) -> int:
    """Kernel records a window lost: the launches in its :data:`MARK`
    range (a card clock's holds and earlier tries too) whose correlation
    id has no kernel event."""
    complete = [ev for ev in doc["traceEvents"]
                if isinstance(ev, dict) and ev.get("ph") == "X"]
    ranges = _ranges(complete, MARK)
    ids = {(ev.get("args") or {}).get("correlation") for ev in complete
           if _is_launch(ev) and _inside(ev, ranges)}
    seen = {(ev.get("args") or {}).get("correlation") for ev in complete
            if str(ev.get("cat", "")).lower() == "kernel"}
    return len(ids - seen)


def _collect_trace(sample_fn: Callable[[], object], log_dir: Path,
                   ) -> tuple[dict, float, str]:
    """Run ``sample_fn`` once in a profiler window, inside a :data:`MARK`
    range, after a warm-up step (not in the exported trace), a
    :data:`GUARD_S` hold and :data:`PRIMER` throwaway kernels on the
    card, and :data:`GUARD_S` before the window closes; returns the exported
    trace, the host bracket of the call (sample + synchronize) and the
    trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from torch.profiler import schedule

    cuda = device_timing_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    # one warm-up step before the recorded one: the tracer (CUPTI on the
    # card) starts there; and each step opens with PRIMER throwaway
    # kernels, whose records the tracer may drop as a step starts, so
    # the sample runs only after them
    live = cuda and torch.cuda.is_initialized()
    pad = torch.zeros(1, device=torch.cuda.current_device()) if live \
        else None

    def primer():
        if pad is not None:
            torch.cuda._sleep(_GUARD_CYCLES)
            for _ in range(PRIMER):
                pad.add_(1.0)
            torch.cuda.synchronize()

    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        primer()
        prof.step()
        primer()
        with record_function(MARK):
            t0 = time.perf_counter()
            sample_fn()
            if live:
                # drain the queue so the bracket closes after the device
                # work it is compared against (skew_s)
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        if live:
            time.sleep(GUARD_S)
        prof.step()
    path = log_dir / TRACE_FILE
    prof.export_chrome_trace(str(path))
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh), host_s, str(path)


def _profiled(sample_fn, log_dir) -> tuple[Optional[DeviceOps], float]:
    tmp = None
    try:
        if log_dir is None:
            tmp = tempfile.mkdtemp(prefix="repro-torch-devprof-")
            log_dir = tmp
        root = Path(log_dir)
        root.mkdir(parents=True, exist_ok=True)
        with _PROFILE_LOCK:
            doc, host_s, source = _collect_trace(sample_fn, root)
        ops = parse_trace(doc, source, MARK)
        if ops is not None:
            metrics().inc("device_timing.lost_kernel_records",
                          _lost_records(doc))
        return ops, host_s
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def profile_ops(sample_fn: Callable[[], object],
                log_dir: Optional[str | Path] = None,
                ) -> Optional[DeviceOps]:
    """Profile one call of ``sample_fn``; per-kernel device time. Same
    contract as :func:`profile_sample`."""
    return _profiled(sample_fn, log_dir)[0]


def profile_sample(sample_fn: Callable[[], object],
                   log_dir: Optional[str | Path] = None,
                   ) -> Optional[DeviceTiming]:
    """Profile one call of ``sample_fn`` under ``torch.profiler``; device
    time against the host bracket. ``None`` where the window holds no
    device work; :class:`DeviceTimingError` where the call launched a
    kernel the profiler did not record.

    ``log_dir=None`` uses (and removes) a temporary directory; pass a
    path to keep the exported trace for inspection.
    """
    ops, host_s = _profiled(sample_fn, log_dir)
    if ops is None:
        return None
    return DeviceTiming(device_time_s=ops.total_s, host_time_s=host_s,
                        skew_s=host_s - ops.total_s, n_events=ops.n_events,
                        source=ops.source)
