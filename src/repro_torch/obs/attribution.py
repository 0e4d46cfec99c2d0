"""Whole-model roofline attribution: per-op cost vs the empirical roofs.

The tuner's roofs (DGEMM ``F_p``, TRIAD ``B_a``) only pay off when real
workloads can be placed on them. This module takes one
:class:`~repro_torch.models.workloads.ModelWorkload`, counts one eager
call of it per op (:func:`repro_torch.analysis.ops.count_ops`: FLOPs from
torch's formula registry, which holds the hand kernels' ops, bytes read
and written), joins each op's FLOPs/bytes with its measured device time
on the card, classifies every op compute- vs memory-bound against the
roofs recovered from the trial cache, and reports per-op and
per-subsystem %-of-roof with an explicit unattributed-time remainder.

Two modes:

- **measured** — the workload's tensors are on the card: one warm-up
  call, then one call inside a ``torch.profiler`` window
  (:func:`repro_torch.obs.device_timing.profile_ops`) under the op
  counter, whose per-op ranges let the window charge every kernel to
  the op that launched it; ``%-of-roof`` compares achieved FLOP/s (or
  B/s for flop-free ops) against the attainable roof at the op's
  intensity, and the remainder is the device time no op claimed
  (kernels launched outside every op). On the card there is no
  fallback: a window that records no kernel raises
  :class:`~repro_torch.obs.device_timing.DeviceTimingError`.
- **static** — on the host, or with ``force_static``: per-op time is
  *modeled* as ``max(flops/F_p, bytes/B_a)`` — the roofline's own lower
  bound — subsystem shares come from the model, ``%-of-roof`` is 100 by
  construction, and the remainder is exactly zero. Every op still
  carries a subsystem label and bound class, so the dashboard section
  renders identically on the host and on the card.

%-of-roof is reported unclamped: a bf16 tensor-core op can exceed 100
against an f32 DGEMM ``F_p``, as a bf16 op can against the reference's.
Without roofs (empty trial cache) ops still get costs and intensities
but classify as ``unclassified`` — the report degrades, never raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from ..analysis.ops import ModuleOps

__all__ = [
    "AttributedOp",
    "AttributionReport",
    "Roofs",
    "attribute",
    "attribution_from_static",
    "roofs_from_trials",
]


# ---------------------------------------------------------------------------
# Roofs recovered from the trial cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Roofs:
    """The empirical ceilings one attribution classifies against."""

    peak_flops: float                   # F_p, FLOP/s
    bandwidths: dict[str, float]        # subsystem -> B_a, bytes/s
    fingerprint: str = ""

    @property
    def default_subsystem(self) -> str:
        """The outermost (slowest) memory level — the conservative slope
        an op of unknown residency is classified against."""
        return min(self.bandwidths, key=self.bandwidths.get)

    def ridge(self, subsystem: Optional[str] = None) -> float:
        b = self.bandwidths[subsystem or self.default_subsystem]
        return self.peak_flops / b

    def attainable(self, intensity: float,
                   subsystem: Optional[str] = None) -> float:
        b = self.bandwidths[subsystem or self.default_subsystem]
        return min(b * intensity, self.peak_flops)

    def classify(self, intensity: float) -> tuple[str, str]:
        """(subsystem, bound) of one op by its arithmetic intensity."""
        sub = self.default_subsystem
        bound = "compute" if intensity >= self.ridge(sub) else "memory"
        return sub, bound

    def model_time(self, flops: float, bytes_accessed: float) -> float:
        """Roofline lower-bound time: max of compute and memory terms."""
        t_c = flops / self.peak_flops if self.peak_flops > 0 else 0.0
        b = self.bandwidths[self.default_subsystem]
        t_m = bytes_accessed / b if b > 0 else 0.0
        return max(t_c, t_m)

    def to_json(self) -> dict:
        return {"peak_flops": self.peak_flops,
                "bandwidths": dict(self.bandwidths),
                "fingerprint": self.fingerprint}


def roofs_from_trials(paths: Sequence[str],
                      fingerprint: Optional[str] = None) -> Optional[Roofs]:
    """Recover ``F_p``/``B_a`` from cached trials (the paper's end
    product, reassembled from disk).

    Prefers the report matching ``fingerprint`` (default: this card's
    :func:`~repro_torch.core.cache.hardware_fingerprint`), falling back
    to the first reportable fingerprint; ``None`` when no cache path
    yields a complete report.
    """
    from ..core.cache import load_trials
    from ..core.report import build_reports

    trials = []
    for p in paths:
        try:
            trials.extend(load_trials(p))
        except (OSError, ValueError):
            continue
    if not trials:
        return None
    reports, _ = build_reports(trials)
    if not reports:
        return None
    if fingerprint is None:
        try:
            from ..core.cache import hardware_fingerprint

            fingerprint = hardware_fingerprint()
        except Exception:      # no card: fall back to the first report
            fingerprint = None
    chosen = next((r for r in reports if r.fingerprint == fingerprint),
                  reports[0])
    return Roofs(
        peak_flops=chosen.model.machine.peak_flops,
        bandwidths=dict(chosen.model.machine.mem_bandwidths),
        fingerprint=chosen.fingerprint)


# ---------------------------------------------------------------------------
# Attribution records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttributedOp:
    """One op placed on the roofline."""

    name: str
    kind: str
    flops: float
    bytes_accessed: float
    intensity: float            # FLOP/byte (inf for flop-only ops)
    time_s: Optional[float]     # measured (or modeled, static mode)
    subsystem: str              # memory subsystem label | "unclassified"
    bound: str                  # "compute" | "memory" | "unclassified"
    pct_of_roof: Optional[float]
    modeled: bool               # False: cost model had no formula

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if math.isinf(self.intensity):
            d["intensity"] = None  # JSON has no Infinity
        return d


@dataclasses.dataclass(frozen=True)
class AttributionReport:
    """Per-op and per-subsystem roofline placement of one workload."""

    workload: str
    mode: str                            # "measured" | "static"
    ops: tuple[AttributedOp, ...]
    total_flops: float
    total_bytes: float
    device_total_s: Optional[float]      # None in static mode
    attributed_s: float                  # sum of joined / modeled op time
    unattributed_s: float                # device_total - attributed (0 static)
    subsystem_seconds: dict[str, float]  # "compute" + memory subsystems
    roofs: Optional[Roofs]
    unhandled: dict[str, int]            # op kinds the cost model skipped
    fingerprint: str = ""

    @property
    def unattributed_frac(self) -> float:
        total = (self.device_total_s if self.device_total_s
                 else self.attributed_s)
        if not total:
            return 0.0
        return self.unattributed_s / total

    def top_ops(self, n: int = 20) -> tuple[AttributedOp, ...]:
        """Heaviest ops first: by time when we have it, else by FLOPs
        then bytes (static mode always has modeled time)."""
        def weight(op: AttributedOp):
            return (op.time_s if op.time_s is not None else 0.0,
                    op.flops, op.bytes_accessed)
        return tuple(sorted(self.ops, key=weight, reverse=True)[:n])

    def to_json(self) -> dict:
        return {
            "workload": self.workload,
            "mode": self.mode,
            "fingerprint": self.fingerprint,
            "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "device_total_s": self.device_total_s,
            "attributed_s": self.attributed_s,
            "unattributed_s": self.unattributed_s,
            "unattributed_frac": self.unattributed_frac,
            "subsystem_seconds": dict(self.subsystem_seconds),
            "roofs": self.roofs.to_json() if self.roofs else None,
            "unhandled": dict(self.unhandled),
            "ops": [op.to_json() for op in self.ops],
        }

    def to_markdown(self, max_ops: int = 20) -> str:
        """Self-contained markdown: per-op table + subsystem summary."""
        lines = [f"## Roofline attribution: `{self.workload}` "
                 f"({self.mode})", ""]
        if self.roofs is not None:
            bw = ", ".join(f"{k}={v:.3g} B/s"
                           for k, v in sorted(self.roofs.bandwidths.items()))
            lines.append(f"Roofs: F_p={self.roofs.peak_flops:.3g} FLOP/s; "
                         f"{bw} (`{self.roofs.fingerprint or 'n/a'}`)")
        else:
            lines.append("Roofs: none recovered — ops are unclassified.")
        lines.append("")
        header = ["op", "kind", "FLOPs", "bytes", "I (FLOP/B)",
                  "time", "subsystem", "bound", "% of roof"]
        rows = []
        for op in self.top_ops(max_ops):
            rows.append([
                f"`{op.name}`", op.kind, f"{op.flops:.4g}",
                f"{op.bytes_accessed:.4g}",
                "∞" if math.isinf(op.intensity) else f"{op.intensity:.3g}",
                (f"{op.time_s * 1e6:.3g}µs" if op.time_s is not None
                 else "—"),
                op.subsystem, op.bound,
                (f"{op.pct_of_roof:.1f}%" if op.pct_of_roof is not None
                 else "—"),
            ])
        lines.append("| " + " | ".join(header) + " |")
        lines.append("|" + "|".join("---" for _ in header) + "|")
        lines += ["| " + " | ".join(r) + " |" for r in rows]
        if len(self.ops) > max_ops:
            lines.append("")
            lines.append(f"({len(self.ops) - max_ops} further ops elided)")
        lines.append("")
        lines.append("### Subsystem shares")
        lines.append("")
        total = sum(self.subsystem_seconds.values()) + self.unattributed_s
        lines.append("| subsystem | time | share |")
        lines.append("|---|---|---|")
        for sub, secs in sorted(self.subsystem_seconds.items()):
            share = 100.0 * secs / total if total else 0.0
            lines.append(f"| {sub} | {secs * 1e6:.3g}µs | {share:.1f}% |")
        u_share = 100.0 * self.unattributed_s / total if total else 0.0
        lines.append(f"| *unattributed* | {self.unattributed_s * 1e6:.3g}µs "
                     f"| {u_share:.1f}% |")
        lines.append("")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def _attr_op(op, time_s: Optional[float], roofs: Optional[Roofs],
             static: bool) -> AttributedOp:
    intensity = op.intensity
    if roofs is None:
        return AttributedOp(
            name=op.name, kind=op.kind, flops=op.flops,
            bytes_accessed=op.bytes_accessed, intensity=intensity,
            time_s=time_s, subsystem="unclassified", bound="unclassified",
            pct_of_roof=None, modeled=op.modeled)
    sub, bound = roofs.classify(intensity)
    pct: Optional[float] = None
    if static:
        # modeled time saturates the roof by construction: the static
        # fallback reports *where* time must go, not how well it is spent
        pct = 100.0
    elif time_s and time_s > 0:
        if op.flops > 0 and not math.isinf(intensity):
            roof = roofs.attainable(intensity, sub)
            pct = 100.0 * (op.flops / time_s) / roof if roof > 0 else 0.0
        elif op.flops > 0:
            pct = 100.0 * (op.flops / time_s) / roofs.peak_flops
        elif op.bytes_accessed > 0:
            b = roofs.bandwidths[sub]
            pct = 100.0 * (op.bytes_accessed / time_s) / b if b > 0 else 0.0
    return AttributedOp(
        name=op.name, kind=op.kind, flops=op.flops,
        bytes_accessed=op.bytes_accessed, intensity=intensity,
        time_s=time_s, subsystem=sub, bound=bound, pct_of_roof=pct,
        modeled=op.modeled)


def _subsystem_seconds(ops: Sequence[AttributedOp]) -> dict[str, float]:
    """Time bucketed by bound class: compute-bound ops under "compute",
    memory-bound ops under their subsystem, unclassified under its own
    key — the stacked-bar data of the dashboard section."""
    out: dict[str, float] = {}
    for op in ops:
        if op.time_s is None:
            continue
        key = "compute" if op.bound == "compute" else (
            op.subsystem if op.bound == "memory" else "unclassified")
        out[key] = out.get(key, 0.0) + op.time_s
    return out


def attribution_from_static(workload_name: str, module: ModuleOps,
                            roofs: Optional[Roofs],
                            fingerprint: str = "") -> AttributionReport:
    """Static attribution (the host's mode): op time is the roofline
    model's own lower bound, the remainder is exactly zero."""
    attributed: list[AttributedOp] = []
    for op in module.ops:
        t = roofs.model_time(op.flops, op.bytes_accessed) if roofs else None
        attributed.append(_attr_op(op, t, roofs, static=True))
    total_t = sum(op.time_s or 0.0 for op in attributed)
    return AttributionReport(
        workload=workload_name, mode="static", ops=tuple(attributed),
        total_flops=module.flops, total_bytes=module.bytes_accessed,
        device_total_s=None, attributed_s=total_t, unattributed_s=0.0,
        subsystem_seconds=_subsystem_seconds(attributed), roofs=roofs,
        unhandled=dict(module.unhandled), fingerprint=fingerprint)


def _attribution_from_device(workload_name: str, module: ModuleOps,
                             device, roofs: Optional[Roofs],
                             fingerprint: str = "") -> AttributionReport:
    attributed: list[AttributedOp] = []
    joined = 0.0
    for op in module.ops:
        t = device.by_op.get(op.name)
        if t is not None:
            joined += t
        attributed.append(_attr_op(op, t, roofs, static=False))
    return AttributionReport(
        workload=workload_name, mode="measured", ops=tuple(attributed),
        total_flops=module.flops, total_bytes=module.bytes_accessed,
        device_total_s=device.total_s, attributed_s=joined,
        unattributed_s=max(device.total_s - joined, 0.0),
        subsystem_seconds=_subsystem_seconds(attributed), roofs=roofs,
        unhandled=dict(module.unhandled), fingerprint=fingerprint)


def _device(workload):
    """The device of the workload's first tensor argument (None if it has
    none)."""
    import torch
    from torch.utils._pytree import tree_flatten

    leaves, _ = tree_flatten(workload.args)
    return next((t.device for t in leaves if isinstance(t, torch.Tensor)),
                None)


def attribute(workload, roofs: Optional[Roofs] = None, *,
              force_static: bool = False,
              log_dir: Optional[str] = None) -> AttributionReport:
    """Attribute one :class:`~repro_torch.models.workloads.ModelWorkload`.

    On the card (the workload's tensors on ``cuda``) the measured path
    runs unless ``force_static``: one warm-up call, then one call under
    the op counter inside a profiler window (``log_dir`` keeps its
    trace); a window without a kernel raises. On the host, or with
    ``force_static``, the ops of one call are counted and attributed
    statically. Emits the ``attribution``/``attribution_op`` trace
    instants so the Perfetto export carries op-level context.
    """
    import torch

    from ..analysis.ops import OpCounter, count_ops
    from ..core.profiling import trace_instant

    dev = _device(workload)
    fingerprint = ""
    try:
        from ..core.cache import hardware_fingerprint

        fingerprint = hardware_fingerprint(
            "cuda" if dev is not None and dev.type == "cuda" else "cpu")
    except Exception:      # an unreadable fingerprint only leaves it blank
        pass
    if dev is not None and dev.type == "cuda" and not force_static:
        from .device_timing import DeviceTimingError, profile_ops

        workload.fn(*workload.args)            # warm-up: builds, handles
        torch.cuda.synchronize(dev)
        counter = OpCounter(mark=True)

        def sample():
            with counter:
                workload.fn(*workload.args)

        device = profile_ops(sample, log_dir=log_dir)
        if device is None:
            raise DeviceTimingError(
                f"attributing {workload.name} on {dev}: the profiler "
                f"window recorded no kernel")
        report = _attribution_from_device(workload.name, counter.module(),
                                          device, roofs, fingerprint)
    else:
        module = count_ops(workload.fn, workload.args)
        report = attribution_from_static(workload.name, module, roofs,
                                         fingerprint)
    trace_instant("attribution", workload=report.workload, mode=report.mode,
                  n_ops=len(report.ops), total_flops=report.total_flops,
                  total_bytes=report.total_bytes,
                  unattributed_frac=report.unattributed_frac)
    for op in report.top_ops(10):
        trace_instant("attribution_op", workload=report.workload,
                      op=op.name, kind=op.kind, flops=op.flops,
                      bytes=op.bytes_accessed, subsystem=op.subsystem,
                      bound=op.bound,
                      pct_of_roof=op.pct_of_roof)
    return report
