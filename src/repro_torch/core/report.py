"""Cache-backed roofline dashboards (ROADMAP: the cache as system of record).

The paper's end product is a roofline model assembled from *measured* peaks:
the autotuned DGEMM incumbent supplies the compute ceiling ``F_p`` and the
autotuned TRIAD incumbents supply each memory subsystem's bandwidth slope
``B_a`` (paper Sec. II-III). Every trial behind those peaks is already
persisted by :mod:`repro_torch.core.cache` with exact Welford moments and a
hardware fingerprint, so the model — and a confidence interval for every
peak — can be reassembled from disk at any time without re-measuring,
treating trial archives as reusable artifacts the way *Towards a
Benchmarking Suite for Kernel Tuners* (arXiv:2303.08976) prescribes.

Pipeline:

  :func:`~repro_torch.core.cache.load_trials`  (one file or a session directory)
      -> :func:`group_by_fingerprint`
      -> :func:`extract_incumbent` / :func:`triad_subsystems`
      -> :func:`build_reports`   (one :class:`FingerprintReport` per machine)
      -> :func:`render_markdown` / :func:`render_csv`

Unit convention: trial scores are **GFLOP/s** for the compute benchmark and
**GB/s** for the bandwidth benchmark (the ``timed_sampler(work=…/1e9)``
contract in ``benchmarks/common.py``); ``unit_scale`` converts them to
FLOP/s and B/s for the model. Incumbent selection matches
``TrialCache.best`` exactly — best non-pruned score, first-seen wins ties —
so a report names the same winner a resumed ``TuningSession`` warm-starts
from.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

from . import welford
from .cache import CachedTrial, config_key
from .confidence import Interval, ci_mean
from .roofline import (TRIAD_INTENSITY, RooflineModel, from_measurements,
                       operational_intensity, ridge_point)
from .searchspace import Config
from .stop_conditions import Direction
from .welford import WelfordState

__all__ = ["FingerprintReport", "IncumbentTrial", "build_reports",
           "dgemm_config_intensity", "extract_incumbent",
           "group_by_fingerprint", "pooled_state", "render_csv",
           "render_markdown", "trials_from_result", "triad_subsystems"]

#: Benchmark names the CLIs record under (``scripts/tune.py --benchmark``).
DGEMM_BENCHMARK = "dgemm"
TRIAD_BENCHMARK = "triad"

#: Scores are GFLOP/s / GB/s; the roofline model wants FLOP/s / B/s.
UNIT_SCALE = 1e9


# ---------------------------------------------------------------------------
# Incumbent extraction (must mirror TrialCache.best / warm-start selection)
# ---------------------------------------------------------------------------


def pooled_state(result) -> WelfordState:
    """Exact sample-level moments of an :class:`EvalResult`, recovered by
    merging every invocation's stored (count, mean, m2) with the Chan et
    al. combiner — the cache's exact-Welford round-trip makes this
    bit-identical to having streamed all samples into one accumulator."""
    return welford.tree_merge([
        WelfordState(count=float(i.count), mean=i.mean, m2=i.m2)
        for i in result.invocations])


@dataclasses.dataclass(frozen=True)
class IncumbentTrial:
    """A benchmark's best cached trial, with its CI recoverable from the
    stored moments."""

    trial: CachedTrial

    @property
    def benchmark(self) -> str:
        return self.trial.benchmark

    @property
    def config(self) -> Config:
        return self.trial.config

    @property
    def score(self) -> float:
        return self.trial.result.score

    @property
    def total_samples(self) -> int:
        return self.trial.result.total_samples

    @property
    def strategy(self) -> Optional[str]:
        """Search strategy that produced this incumbent (``None`` for
        records predating the strategy layer)."""
        return self.trial.strategy

    def interval(self, confidence: float = 0.99) -> Interval:
        """CI of the mean over the pooled sample stream (same units as
        ``score``)."""
        return ci_mean(pooled_state(self.trial.result), confidence)


def extract_incumbent(trials: Iterable[CachedTrial], benchmark: str,
                      direction: Direction = Direction.MAXIMIZE,
                      ) -> Optional[IncumbentTrial]:
    """Best non-pruned trial of one benchmark — the selection rule of
    ``TrialCache.best`` (pruned trials carry truncated estimates and never
    win; ties keep the first-seen trial), so the reported incumbent is the
    one a resumed session would warm-start from."""
    best: Optional[CachedTrial] = None
    for t in trials:
        if t.benchmark != benchmark or t.result.pruned:
            continue
        if best is None or direction.better(t.result.score,
                                            best.result.score):
            best = t
    return IncumbentTrial(best) if best is not None else None


def group_by_fingerprint(trials: Iterable[CachedTrial],
                         ) -> dict[str, list[CachedTrial]]:
    """Trials bucketed by hardware fingerprint, insertion order preserved
    within each bucket (timings do not transfer across hardware, so every
    downstream aggregation happens per bucket)."""
    groups: dict[str, list[CachedTrial]] = {}
    for t in trials:
        groups.setdefault(t.fingerprint, []).append(t)
    return groups


# ---------------------------------------------------------------------------
# Benchmark-specific interpretation
# ---------------------------------------------------------------------------


def dgemm_config_intensity(config: Config,
                           itemsize: int = 4) -> Optional[float]:
    """Operational intensity of one (n, m, k) matmul config: 2nmk FLOPs
    over the three operand/result arrays (paper Eq. 1). None when the
    config does not look like a matmul."""
    try:
        n, m, k = int(config["n"]), int(config["m"]), int(config["k"])
    except (KeyError, TypeError, ValueError):
        return None
    return operational_intensity(2.0 * n * m * k,
                                 float(itemsize) * (n * k + k * m + n * m))


def _humanize_bytes(n: float) -> str:
    for unit, scale in (("GiB", 2 ** 30), ("MiB", 2 ** 20), ("KiB", 2 ** 10)):
        if n >= scale:
            return f"{n / scale:g}{unit}"
    return f"{n:g}B"


def _subsystem_name(config: Config) -> str:
    """Stable display name of the memory subsystem one TRIAD config probes
    (working-set size decides which level of the hierarchy it streams)."""
    if set(config) == {"n_bytes"}:
        return f"mem[{_humanize_bytes(config['n_bytes'])}]"
    return "mem[" + ";".join(f"{k}={config[k]}" for k in sorted(config)) + "]"


def triad_subsystems(trials: Iterable[CachedTrial],
                     benchmark: str = TRIAD_BENCHMARK,
                     direction: Direction = Direction.MAXIMIZE,
                     ) -> dict[str, IncumbentTrial]:
    """Per-config TRIAD incumbents, one memory subsystem each.

    Each distinct TRIAD configuration (e.g. cache-resident vs streaming
    working set) probes a different memory subsystem, so its own best
    non-pruned trial becomes that subsystem's measured ``B_a``. Configs
    whose every trial was pruned are dropped: pruned bandwidths are
    truncated estimates.
    """
    per_config: dict[str, CachedTrial] = {}
    for t in trials:
        if t.benchmark != benchmark or t.result.pruned:
            continue
        prev = per_config.get(t.key)
        if prev is None or direction.better(t.result.score,
                                            prev.result.score):
            per_config[t.key] = t
    out = {_subsystem_name(t.config): IncumbentTrial(t)
           for t in per_config.values()}
    return dict(sorted(out.items()))


def trials_from_result(result, benchmark: str,
                       fingerprint: str) -> list[CachedTrial]:
    """Adapt an in-memory :class:`~repro_torch.core.tuner.TuningResult` to the
    reporting layer's input, so fresh runs can render the same dashboards
    as persisted caches."""
    strategy = getattr(result, "strategy", None)
    return [CachedTrial(benchmark=benchmark, fingerprint=fingerprint,
                        config=t.config, result=t.result, strategy=strategy)
            for t in result.trials]


# ---------------------------------------------------------------------------
# Report assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FingerprintReport:
    """One machine's measured roofline: model, incumbents, kernel marks."""

    fingerprint: str
    model: RooflineModel
    dgemm: IncumbentTrial
    bandwidths: tuple[tuple[str, IncumbentTrial], ...]  # name-sorted
    marks: tuple[tuple[str, float, float], ...]         # (label, I, FLOP/s)
    n_trials: int
    confidence: float = 0.99
    unit_scale: float = UNIT_SCALE   # score units -> FLOP/s / B/s

    @property
    def peak_flops(self) -> float:
        return self.model.machine.peak_flops

    def gap_rows(self) -> list[dict]:
        """Model-vs-measured rows. A mark labeled ``<kernel>:<subsystem>``
        (the TRIAD convention) gaps only against its own subsystem's roof —
        a cache-resident stream measured against the DRAM slope would show
        a meaningless >100% "gap"; unqualified marks gap against every
        subsystem."""
        subsystems = set(self.model.machine.mem_bandwidths)
        rows = []
        for row in self.model.gap_table(self.marks):
            _, _, qualifier = row["kernel"].partition(":")
            if qualifier in subsystems and row["subsystem"] != qualifier:
                continue
            rows.append(row)
        return rows


def build_reports(trials: Sequence[CachedTrial], *,
                  dgemm_benchmark: str = DGEMM_BENCHMARK,
                  triad_benchmark: str = TRIAD_BENCHMARK,
                  direction: Direction = Direction.MAXIMIZE,
                  unit_scale: float = UNIT_SCALE,
                  confidence: float = 0.99,
                  ) -> tuple[list[FingerprintReport],
                             list[tuple[str, str]]]:
    """Assemble one report per hardware fingerprint.

    A fingerprint is reportable when it has at least one unpruned trial of
    *both* benchmarks (DGEMM for ``F_p``, TRIAD for the ``B_a`` slopes);
    the second return value lists the fingerprints skipped, with reasons.
    Reports come back sorted by fingerprint for deterministic rendering.
    """
    reports: list[FingerprintReport] = []
    skipped: list[tuple[str, str]] = []
    for fp, group in sorted(group_by_fingerprint(trials).items()):
        peak = extract_incumbent(group, dgemm_benchmark, direction)
        bws = triad_subsystems(group, triad_benchmark, direction)
        if peak is None:
            skipped.append((fp, f"no unpruned {dgemm_benchmark!r} trials"))
            continue
        if not bws:
            skipped.append((fp, f"no unpruned {triad_benchmark!r} trials"))
            continue
        model = from_measurements(
            fp, peak.score * unit_scale,
            {name: inc.score * unit_scale for name, inc in bws.items()})
        marks: list[tuple[str, float, float]] = []
        dgemm_i = dgemm_config_intensity(peak.config)
        if dgemm_i is not None:
            marks.append((dgemm_benchmark, dgemm_i, peak.score * unit_scale))
        for name, inc in bws.items():
            # TRIAD achieves B_a at I = 1/12 by construction, so its marker
            # sits on its own slope: F = B_a * I.
            marks.append((f"{triad_benchmark}:{name}", TRIAD_INTENSITY,
                          inc.score * unit_scale * TRIAD_INTENSITY))
        reports.append(FingerprintReport(
            fingerprint=fp, model=model, dgemm=peak,
            bandwidths=tuple(bws.items()), marks=tuple(marks),
            n_trials=len(group), confidence=confidence,
            unit_scale=unit_scale))
    return reports, skipped


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _num(x: float) -> str:
    return f"{x:.4g}"


def _margin(interval: Interval) -> str:
    return "n/a" if math.isinf(interval.margin) else f"±{interval.margin:.3g}"


def _md_table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> list[str]:
    lines = ["| " + " | ".join(header) + " |",
             "|" + "|".join("---" for _ in header) + "|"]
    lines += ["| " + " | ".join(r) + " |" for r in rows]
    return lines


def render_markdown(reports: Sequence[FingerprintReport],
                    skipped: Sequence[tuple[str, str]] = ()) -> str:
    """The dashboard: per-fingerprint measured peaks (with CIs), ASCII
    roofline with achieved-kernel markers, %-of-roof gap table, and a
    side-by-side comparison across fingerprints."""
    n_trials = sum(r.n_trials for r in reports)
    lines = ["# Cache-backed roofline dashboard", ""]
    lines.append(f"Assembled from {n_trials} cached trials across "
                 f"{len(reports)} hardware fingerprint(s), without "
                 f"re-measuring.")
    lines.append("")
    for r in reports:
        conf_pct = f"{r.confidence * 100:g}%"
        # scores are GFLOP/s / GB/s under the default scale; under a custom
        # unit_scale they are whatever the caller measured
        gf, gb = (("GFLOP/s", "GB/s") if r.unit_scale == UNIT_SCALE
                  else ("(score)", "(score)"))
        lines.append(f"## Fingerprint `{r.fingerprint}`")
        lines.append("")
        # annotate which search strategy produced each incumbent, when any
        # trial recorded one (records predating the strategy layer do not)
        annotate = (r.dgemm.strategy is not None
                    or any(inc.strategy is not None
                           for _, inc in r.bandwidths))

        def _via(inc: IncumbentTrial) -> list[str]:
            if not annotate:
                return []
            return [inc.strategy if inc.strategy is not None else "—"]

        rows = []
        iv = r.dgemm.interval(r.confidence)
        rows.append(["peak compute F_p (dgemm)",
                     f"{_num(r.dgemm.score)} {gf}", _margin(iv),
                     f"`{config_key(r.dgemm.config)}`",
                     str(r.dgemm.total_samples)] + _via(r.dgemm))
        for name, inc in r.bandwidths:
            iv = inc.interval(r.confidence)
            rows.append([f"bandwidth B_a {name} (triad)",
                         f"{_num(inc.score)} {gb}", _margin(iv),
                         f"`{config_key(inc.config)}`",
                         str(inc.total_samples)] + _via(inc))
        for name, _ in r.bandwidths:
            ridge = ridge_point(r.peak_flops,
                                r.model.machine.mem_bandwidths[name])
            rows.append([f"ridge point I* {name}",
                         f"{_num(ridge)} FLOP/B", "", "", ""]
                        + ([""] if annotate else []))
        lines += _md_table(["quantity", "value", f"{conf_pct} CI",
                            "incumbent config", "samples"]
                           + (["strategy"] if annotate else []), rows)
        lines += ["", "```text", r.model.dashboard(marks=r.marks), "```", ""]
        lines.append("### Model vs measured (% of roof)")
        lines.append("")
        unit = "GFLOP/s" if r.unit_scale == UNIT_SCALE else "FLOP/s"
        scale = r.unit_scale if r.unit_scale == UNIT_SCALE else 1.0
        gap_rows = [[g["kernel"], g["subsystem"],
                     _num(g["intensity_flop_per_byte"]),
                     f"{_num(g['achieved_flops'] / scale)} {unit}",
                     f"{_num(g['attainable_flops'] / scale)} {unit}",
                     f"{g['pct_of_roof']:.1f}%", g["bound"]]
                    for g in r.gap_rows()]
        lines += _md_table(["kernel", "subsystem", "I (FLOP/B)", "achieved",
                            "attainable", "% of roof", "bound"], gap_rows)
        lines.append("")
    if len(reports) > 1:
        lines.append("## Fingerprint comparison")
        lines.append("")
        subsystems = sorted({name for r in reports
                             for name, _ in r.bandwidths})
        default_units = all(r.unit_scale == UNIT_SCALE for r in reports)
        gf, gb = (("GFLOP/s", "GB/s") if default_units
                  else ("score", "score"))
        header = ["quantity"] + [f"`{r.fingerprint}`" for r in reports]
        rows = [[f"peak compute ({gf})"]
                + [_num(r.dgemm.score) for r in reports]]
        for name in subsystems:
            row = [f"B_a {name} ({gb})"]
            for r in reports:
                bw = dict(r.bandwidths).get(name)
                row.append(_num(bw.score) if bw is not None else "—")
            rows.append(row)
        for name in subsystems:
            row = [f"ridge I* {name} (FLOP/B)"]
            for r in reports:
                b = r.model.machine.mem_bandwidths.get(name)
                row.append(_num(ridge_point(r.peak_flops, b))
                           if b is not None else "—")
            rows.append(row)
        rows.append(["best dgemm config"]
                    + [f"`{config_key(r.dgemm.config)}`" for r in reports])
        rows.append(["cached trials"] + [str(r.n_trials) for r in reports])
        lines += _md_table(header, rows)
        lines.append("")
    if skipped:
        lines.append("## Skipped fingerprints")
        lines.append("")
        lines += [f"- `{fp}`: {reason}" for fp, reason in skipped]
        lines.append("")
    return "\n".join(lines)


def render_csv(reports: Sequence[FingerprintReport]) -> str:
    """Flat CSV of every report: measured peaks, roof curves, kernel marks,
    and %-of-roof gap rows. Text cells are sanitized to carry no embedded
    commas (configs as ``;``-separated key=value pairs; commas inside a
    hardware fingerprint — multi-device-kind hosts — become ``;``), so
    every row has exactly 7 naive-split fields."""

    def txt(s: str) -> str:
        return str(s).replace(",", ";")

    def cfg(c: Config) -> str:
        return ";".join(f"{k}={c[k]}" for k in sorted(c))

    rows = ["fingerprint,kind,name,intensity_flop_per_byte,value,"
            "pct_of_roof,config"]
    for r in reports:
        fp = txt(r.fingerprint)
        rows.append(f"{fp},peak_flops,{txt(r.dgemm.benchmark)},,"
                    f"{r.peak_flops:.6g},,{cfg(r.dgemm.config)}")
        for name, inc in r.bandwidths:
            rows.append(f"{fp},bandwidth,{txt(name)},,"
                        f"{inc.score * r.unit_scale:.6g},,{cfg(inc.config)}")
        for name, _ in r.bandwidths:
            for i, f in r.model.curve(name):
                rows.append(f"{fp},curve,{txt(name)},{i:.6g},{f:.6g},,")
        for label, mi, mf in r.marks:
            rows.append(f"{fp},mark,{txt(label)},{mi:.6g},{mf:.6g},,")
        for g in r.gap_rows():
            rows.append(f"{fp},gap,{txt(g['kernel'])}/{txt(g['subsystem'])},"
                        f"{g['intensity_flop_per_byte']:.6g},"
                        f"{g['achieved_flops']:.6g},"
                        f"{g['pct_of_roof']:.2f},")
    return "\n".join(rows)
