"""Trend rendering: single-file HTML dashboards and ASCII sparklines.

ROADMAP asked for "HTML/plot output beyond markdown/ASCII"; this module
supplies it without adding a single dependency. The dashboard is **one
self-contained HTML file** — inline CSS, inline vanilla JS, inline SVG
generated here in Python with fixed-precision coordinates — so it can be
attached to a CI run, mailed, or opened from ``file://`` with no network
access, and so a golden-file test can pin its structure byte-for-byte
(the CARM tool's automatically-rendered comparisons, done the
zero-infrastructure way).

Inputs are the other layers' outputs, all optional and composable:

  * :class:`~repro_torch.core.report.FingerprintReport` rows — per-fingerprint
    measured-roofline summaries with an SVG roofline plot;
  * :class:`~repro_torch.history.ledger.RunRecord` series — per-series trend
    lines with CI bands recovered from the stored Welford moments;
  * a :class:`~repro_torch.history.regression.RegressionReport` — the verdict
    table, colored.

``ascii_sparkline`` / ``render_trend_text`` are the terminal counterparts
used by ``python -m repro_torch.tune --history`` and ``python -m
repro_torch.perf_gate``. The output is the JAX package's, byte for byte,
on the same inputs (the template is a copy of its
``history/templates/dashboard.html``).
"""

from __future__ import annotations

import html
import math
import string
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional, Sequence

from ..core.cache import config_key
from ..core.confidence import ci_mean

from .ledger import RunLedger, RunRecord
from .regression import RegressionReport, detect_regressions

__all__ = ["ascii_sparkline", "render_html", "render_trend_text",
           "write_dashboard"]

_TEMPLATE_PATH = Path(__file__).parent / "templates" / "dashboard.html"

_SPARK_LEVELS = "▁▂▃▄▅▆▇█"

#: categorical palette for roofline subsystem curves (color-blind safe)
_CURVE_COLORS = ("#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951",
                 "#a463f2")


def ascii_sparkline(values: Sequence[float]) -> str:
    """One block-character column per value, scaled to the series range
    (a constant series renders mid-scale). Empty input renders empty."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return _SPARK_LEVELS[3] * len(vals)
    out = []
    for v in vals:
        idx = int((v - lo) / (hi - lo) * (len(_SPARK_LEVELS) - 1))
        out.append(_SPARK_LEVELS[idx])
    return "".join(out)


def render_trend_text(runs: Sequence[RunRecord],
                      confidence: float = 0.99) -> str:
    """Terminal trend view of one series: sparkline plus one line per run
    with its CI margin — what ``python -m repro_torch.tune --history``
    prints."""
    if not runs:
        return "(no history yet)"
    lines = [f"history   : {ascii_sparkline([r.score for r in runs])}  "
             f"({len(runs)} run(s))"]
    for r in runs:
        iv = ci_mean(r.state, confidence)
        margin = "n/a" if math.isinf(iv.margin) else f"±{iv.margin:.3g}"
        via = f"  via {r.strategy}" if r.strategy else ""
        sess = f"  [{r.session}]" if r.session else ""
        lines.append(f"  run {r.run:3d}: {r.score:10.4g} {margin:>10s}  "
                     f"n={int(r.count)}{via}{sess}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# SVG generation (deterministic: every coordinate is rounded)
# ---------------------------------------------------------------------------


def _fmt(x: float) -> str:
    return f"{x:.1f}"


def _trend_svg(runs: Sequence[RunRecord], confidence: float,
               width: int = 560, height: int = 150) -> str:
    """Score-vs-run-index line with a CI band from the stored moments."""
    pad_l, pad_r, pad_t, pad_b = 56, 14, 10, 22
    iw, ih = width - pad_l - pad_r, height - pad_t - pad_b
    points = []
    for k, r in enumerate(runs):
        iv = ci_mean(r.state, confidence)
        lo = iv.lo if not math.isinf(iv.lo) else r.score
        hi = iv.hi if not math.isinf(iv.hi) else r.score
        points.append((k, r.score, lo, hi))
    y_lo = min(p[2] for p in points)
    y_hi = max(p[3] for p in points)
    if y_hi - y_lo <= 0:
        y_lo, y_hi = y_lo - 1.0, y_hi + 1.0
    span = y_hi - y_lo
    y_lo, y_hi = y_lo - 0.08 * span, y_hi + 0.08 * span

    def sx(k: float) -> float:
        denom = max(len(points) - 1, 1)
        return pad_l + k / denom * iw

    def sy(v: float) -> float:
        return pad_t + (1.0 - (v - y_lo) / (y_hi - y_lo)) * ih

    band_pts = [f"{_fmt(sx(k))},{_fmt(sy(hi))}" for k, _, _, hi in points]
    band_pts += [f"{_fmt(sx(k))},{_fmt(sy(lo))}"
                 for k, _, lo, _ in reversed(points)]
    line_pts = " ".join(f"{_fmt(sx(k))},{_fmt(sy(s))}"
                        for k, s, _, _ in points)
    dots = "".join(
        f'<circle class="trend-dot" cx="{_fmt(sx(k))}" cy="{_fmt(sy(s))}" '
        f'r="3"><title>run {runs[k].run}: {s:.4g} '
        f'[{lo:.4g}, {hi:.4g}]</title></circle>'
        for k, s, lo, hi in points)
    x_labels = "".join(
        f'<text x="{_fmt(sx(k))}" y="{height - 6}" text-anchor="middle">'
        f'{runs[k].run}</text>'
        for k, *_ in points)
    parts = [
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" role="img">',
        f'<line class="axis" x1="{pad_l}" y1="{pad_t}" x2="{pad_l}" '
        f'y2="{height - pad_b}"/>',
        f'<line class="axis" x1="{pad_l}" y1="{height - pad_b}" '
        f'x2="{width - pad_r}" y2="{height - pad_b}"/>',
        f'<text x="{pad_l - 6}" y="{pad_t + 10}" text-anchor="end">'
        f'{y_hi:.4g}</text>',
        f'<text x="{pad_l - 6}" y="{height - pad_b}" text-anchor="end">'
        f'{y_lo:.4g}</text>',
        f'<polygon class="trend-band" points="{" ".join(band_pts)}"/>',
        f'<polyline class="trend-line" points="{line_pts}"/>',
        dots, x_labels, "</svg>"]
    return "".join(parts)


def _roofline_svg(report, width: int = 560, height: int = 220) -> str:
    """Log-log roofline of one FingerprintReport: each subsystem's roof
    curve plus achieved-kernel markers."""
    pad_l, pad_r, pad_t, pad_b = 56, 14, 10, 24
    iw, ih = width - pad_l - pad_r, height - pad_t - pad_b
    curves = [(name, report.model.curve(name))
              for name, _ in report.bandwidths]
    xs = [math.log2(i) for _, pts in curves for i, _ in pts]
    ys = [math.log2(max(f, 1.0)) for _, pts in curves for _, f in pts]
    xs += [math.log2(mi) for _, mi, _ in report.marks]
    ys += [math.log2(max(mf, 1.0)) for _, _, mf in report.marks]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)

    def sx(v: float) -> float:
        return pad_l + (v - x0) / max(x1 - x0, 1e-9) * iw

    def sy(v: float) -> float:
        return pad_t + (1.0 - (v - y0) / max(y1 - y0, 1e-9)) * ih

    body = []
    for k, (name, pts) in enumerate(curves):
        color = _CURVE_COLORS[k % len(_CURVE_COLORS)]
        line = " ".join(
            f"{_fmt(sx(math.log2(i)))},{_fmt(sy(math.log2(max(f, 1.0))))}"
            for i, f in pts)
        body.append(f'<polyline class="roof-curve" stroke="{color}" '
                    f'points="{line}"><title>{html.escape(name)}</title>'
                    f'</polyline>')
    for label, mi, mf in report.marks:
        cx = _fmt(sx(math.log2(mi)))
        cy = _fmt(sy(math.log2(max(mf, 1.0))))
        body.append(f'<circle class="roof-mark" cx="{cx}" cy="{cy}" r="4">'
                    f'<title>{html.escape(label)}: I={mi:.4g}, '
                    f'F={mf:.4g}</title></circle>')
    legend = "".join(
        f'<text x="{pad_l + 8 + 130 * k}" y="{pad_t + 12}" '
        f'fill="{_CURVE_COLORS[k % len(_CURVE_COLORS)]}">'
        f'{html.escape(name)}</text>'
        for k, (name, _) in enumerate(curves))
    parts = [
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" role="img">',
        f'<line class="axis" x1="{pad_l}" y1="{pad_t}" x2="{pad_l}" '
        f'y2="{height - pad_b}"/>',
        f'<line class="axis" x1="{pad_l}" y1="{height - pad_b}" '
        f'x2="{width - pad_r}" y2="{height - pad_b}"/>',
        f'<text x="{pad_l - 6}" y="{pad_t + 10}" text-anchor="end">'
        f'2^{y1:.1f}</text>',
        f'<text x="{pad_l - 6}" y="{height - pad_b}" text-anchor="end">'
        f'2^{y0:.1f}</text>',
        f'<text x="{width - pad_r}" y="{height - 6}" text-anchor="end">'
        f'log2(I), FLOP/B</text>',
        *body, legend, "</svg>"]
    return "".join(parts)


# ---------------------------------------------------------------------------
# HTML assembly
# ---------------------------------------------------------------------------


def _esc(s: object) -> str:
    return html.escape(str(s))


def _table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    """Rows are pre-escaped/pre-formatted HTML cell strings."""
    head = "".join(f"<th>{h}</th>" for h in header)
    body = "".join("<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
                   for row in rows)
    return f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"


def _stamp(ts: Optional[float]) -> str:
    if ts is None:
        return "—"
    return datetime.fromtimestamp(ts, tz=timezone.utc).strftime(
        "%Y-%m-%d %H:%M UTC")


def _roofline_section(report) -> str:
    conf_pct = f"{report.confidence * 100:g}%"
    rows = []
    iv = report.dgemm.interval(report.confidence)
    margin = "n/a" if math.isinf(iv.margin) else f"±{iv.margin:.3g}"
    rows.append(["peak compute F_p (dgemm)", f"{report.dgemm.score:.4g}",
                 margin, f"<code>{_esc(config_key(report.dgemm.config))}</code>",
                 str(report.dgemm.total_samples)])
    for name, inc in report.bandwidths:
        iv = inc.interval(report.confidence)
        margin = "n/a" if math.isinf(iv.margin) else f"±{iv.margin:.3g}"
        rows.append([f"bandwidth B_a {_esc(name)} (triad)",
                     f"{inc.score:.4g}", margin,
                     f"<code>{_esc(config_key(inc.config))}</code>",
                     str(inc.total_samples)])
    gap_rows = [[_esc(g["kernel"]), _esc(g["subsystem"]),
                 f"{g['intensity_flop_per_byte']:.4g}",
                 f"{g['achieved_flops']:.4g}", f"{g['attainable_flops']:.4g}",
                 f"{g['pct_of_roof']:.1f}%", _esc(g["bound"])]
                for g in report.gap_rows()]
    return "\n".join([
        f"<h2>Roofline — <code>{_esc(report.fingerprint)}</code></h2>",
        f"<p class=\"meta\">{report.n_trials} cached trials, "
        f"{conf_pct} confidence intervals.</p>",
        _table(["quantity", "value", f"{conf_pct} CI", "incumbent config",
                "samples"], rows),
        _roofline_svg(report),
        "<h3>Model vs measured (% of roof)</h3>",
        _table(["kernel", "subsystem", "I (FLOP/B)", "achieved",
                "attainable", "% of roof", "bound"], gap_rows),
    ])


def _trend_section(benchmark: str, fingerprint: str,
                   runs: Sequence[RunRecord], confidence: float) -> str:
    rows = []
    for r in runs:
        iv = ci_mean(r.state, confidence)
        margin = "n/a" if math.isinf(iv.margin) else f"±{iv.margin:.3g}"
        rows.append([str(r.run), f"{r.score:.4g}", margin,
                     str(int(r.count)),
                     f"<code>{_esc(config_key(r.config))}</code>",
                     _esc(r.strategy or "—"), _esc(r.session or "—"),
                     _stamp(r.timestamp)])
    spark = ascii_sparkline([r.score for r in runs])
    return "\n".join([
        f"<h2>Trend — {_esc(benchmark)} @ "
        f"<code>{_esc(fingerprint)}</code></h2>",
        f"<p class=\"meta\"><span class=\"spark\">{_esc(spark)}</span> "
        f"{len(runs)} run(s)</p>",
        _trend_svg(runs, confidence),
        _table(["run", "score", f"{confidence * 100:g}% CI", "n",
                "incumbent config", "strategy", "session", "timestamp"],
               rows),
    ])


def _verdict_section(report: RegressionReport) -> str:
    rows = []
    for s in report.series:
        spark = f"<span class=\"spark\">{_esc(ascii_sparkline(s.scores))}</span>"
        if s.comparison is None:
            rows.append([_esc(s.benchmark), f"<code>{_esc(s.fingerprint)}</code>",
                         spark, f"<span class=\"verdict-baseline\">baseline"
                         "</span>", f"{s.runs[-1].score:.4g}", "—", "—", "—"])
            continue
        c = s.comparison
        rows.append([
            _esc(s.benchmark), f"<code>{_esc(s.fingerprint)}</code>", spark,
            f"<span class=\"verdict-{_esc(s.verdict)}\">{_esc(s.verdict)}"
            "</span>",
            f"{c.candidate.mean:.4g}", f"{c.baseline.mean:.4g}",
            f"{c.rel_delta:+.2%}",
            f"{c.method}, [{c.interval.lo:.4g}, {c.interval.hi:.4g}]"])
    status = ("all clear" if report.ok
              else f"{len(report.regressions)} confirmed regression(s)")
    return "\n".join([
        "<h2>Regression verdicts</h2>",
        f"<p class=\"meta\">{len(report.series)} series — {status} "
        f"(confidence {report.confidence:g}, min effect "
        f"{report.min_effect:.0%}).</p>",
        _table(["benchmark", "fingerprint", "trend", "verdict", "newest",
                "best prior", "Δ rel", f"{report.confidence * 100:g}% CI "
                "of Δ / candidate"], rows),
    ])


#: per-op rows shown in the attribution table before eliding
_MAX_ATTRIBUTION_ROWS = 30


def _stacked_bar_svg(shares: Sequence[tuple[str, float]],
                     width: int = 560, height: int = 72) -> str:
    """One horizontal stacked bar of (label, seconds) shares with an
    inline legend — the where-does-the-time-go view of an attribution."""
    total = sum(max(s, 0.0) for _, s in shares)
    bar_h, pad = 26, 4
    body = []
    x = 0.0
    for k, (label, secs) in enumerate(shares):
        frac = (max(secs, 0.0) / total) if total > 0 else 0.0
        w = frac * width
        color = _CURVE_COLORS[k % len(_CURVE_COLORS)]
        if label == "unattributed":
            color = "#9498a0"
        if w > 0:
            body.append(
                f'<rect class="attr-bar" x="{_fmt(x)}" y="{pad}" '
                f'width="{_fmt(w)}" height="{bar_h}" fill="{color}">'
                f'<title>{_esc(label)}: {secs * 1e6:.3g}µs '
                f'({frac * 100:.1f}%)</title></rect>')
        x += w
    legend = "".join(
        f'<text x="{8 + 170 * k}" y="{pad + bar_h + 18}" '
        f'fill="{"#9498a0" if label == "unattributed" else _CURVE_COLORS[k % len(_CURVE_COLORS)]}">'
        f'{_esc(label)} {100.0 * max(secs, 0.0) / total if total else 0.0:.1f}%</text>'
        for k, (label, secs) in enumerate(shares))
    return (f'<svg viewBox="0 0 {width} {height}" width="{width}" '
            f'height="{height}" role="img">{"".join(body)}{legend}</svg>')


def _attribution_section(report) -> str:
    """Per-op roofline placement of one workload: cost/time table plus a
    stacked subsystem-share bar. ``report`` is an
    :class:`~repro_torch.obs.attribution.AttributionReport` (the JAX
    package's report has the same shape); the section's words are the
    reference's, byte for byte, so one golden page serves both packages.
    """
    rows = []
    for op in report.top_ops(_MAX_ATTRIBUTION_ROWS):
        intensity = ("∞" if math.isinf(op.intensity)
                     else f"{op.intensity:.3g}")
        rows.append([
            f"<code>{_esc(op.name)}</code>", _esc(op.kind),
            f"{op.flops:.4g}", f"{op.bytes_accessed:.4g}", intensity,
            ("—" if op.time_s is None else f"{op.time_s * 1e6:.3g}"),
            _esc(op.subsystem), _esc(op.bound),
            ("—" if op.pct_of_roof is None else f"{op.pct_of_roof:.1f}%")])
    elided = len(report.ops) - min(len(report.ops), _MAX_ATTRIBUTION_ROWS)
    shares = sorted(report.subsystem_seconds.items())
    shares.append(("unattributed", report.unattributed_s))
    if report.mode == "measured":
        basis = (f"device total {report.device_total_s * 1e6:.3g}µs, "
                 f"unattributed {report.unattributed_frac * 100:.1f}%")
    else:
        basis = ("static HLO attribution (no device tracks): op time is "
                 "the roofline lower bound, remainder exactly 0")
    roofs = report.roofs
    roof_txt = ("no roofs recovered — ops unclassified" if roofs is None
                else f"F_p={roofs.peak_flops:.4g} FLOP/s vs "
                     + ", ".join(f"{k}={v:.4g} B/s"
                                 for k, v in sorted(roofs.bandwidths.items())))
    return "\n".join([
        f"<h2>Attribution — <code>{_esc(report.workload)}</code> "
        f"({_esc(report.mode)})</h2>",
        f"<p class=\"meta\">{len(report.ops)} HLO ops, "
        f"{report.total_flops:.4g} FLOPs, {report.total_bytes:.4g} bytes; "
        f"{_esc(basis)}. Roofs: {_esc(roof_txt)}.</p>",
        _stacked_bar_svg(shares),
        _table(["op", "kind", "FLOPs", "bytes", "I (FLOP/B)", "time µs",
                "subsystem", "bound", "% of roof"], rows),
        (f"<p class=\"meta\">{elided} further op(s) elided.</p>"
         if elided else ""),
    ])


#: default drill-down row cap — campaigns can trace thousands of trials;
#: the dashboard shows the first N and says how many it dropped
#: (``roofline_report --max-trial-rows`` overrides per render)
_MAX_TRIAL_ROWS = 200


def _flags(row: dict) -> str:
    out = []
    if row.get("improved"):
        out.append('<span class="trial-improved" title="new incumbent">★'
                   "</span>")
    if row.get("pruned"):
        out.append("pruned")
    if row.get("cached"):
        out.append("cached")
    return " ".join(out) or "—"


def _trials_section(trials: Sequence[dict],
                    max_rows: int = _MAX_TRIAL_ROWS) -> str:
    """Per-trial drill-down from a trace's ``trial_summaries`` rows."""
    shown = list(trials)[:max(max_rows, 0)]
    rows = []
    for r in shown:
        phases = ", ".join(f"{_esc(k)} {v * 1e3:.2f}ms"
                           for k, v in (r.get("phases") or {}).items())
        cfg = config_key(r["config"]) if r.get("config") else "—"
        score = "—" if r.get("score") is None else f"{r['score']:.4g}"
        worker = "—" if r.get("worker") is None else str(r["worker"])
        rows.append([
            "—" if r.get("index") is None else str(r["index"]),
            f"<code>{_esc(cfg)}</code>", score,
            "—" if r.get("samples") is None else str(r["samples"]),
            str(r.get("invocations", 0)),
            _esc(r.get("stop_reason") or "—"),
            f"{r.get('dur_s', 0.0) * 1e3:.2f}",
            worker, phases or "—", _flags(r)])
    dropped = len(trials) - len(shown)
    note = f" (first {len(shown)} of {len(trials)})" if dropped else ""
    return "\n".join([
        "<h2>Trial drill-down</h2>",
        f"<p class=\"meta\">{len(trials)} traced trial(s){note}.</p>",
        _table(["trial", "config", "score", "samples", "invocations",
                "stop", "wall ms", "worker", "phases", "flags"], rows),
    ])


def render_html(reports: Sequence = (), skipped: Sequence[tuple[str, str]] = (),
                ledger: Optional[RunLedger] = None,
                regression: Optional[RegressionReport] = None,
                title: str = "Performance history dashboard",
                subtitle: Optional[str] = None,
                confidence: float = 0.99,
                trials: Sequence[dict] = (),
                attribution=None,
                max_trial_rows: int = _MAX_TRIAL_ROWS) -> str:
    """Assemble the self-contained dashboard.

    Every argument is optional: a cache-only call renders roofline
    summaries, a ledger-only call renders trends (and verdicts when a
    ``regression`` report is supplied). ``trials`` is a sequence of
    ``repro_torch.obs.export.trial_summaries`` rows rendered as a per-trial
    drill-down table, capped at ``max_trial_rows``. ``attribution`` is
    an attribution report (see :func:`_attribution_section`) rendered
    as a per-op roofline placement section. ``subtitle`` is caller-supplied
    display text (e.g. a generation timestamp) — this function itself
    never reads a clock, so output is deterministic for golden tests.
    """
    sections: list[str] = []
    if regression is not None:
        sections.append(_verdict_section(regression))
    for report in reports:
        sections.append(_roofline_section(report))
    if attribution is not None:
        sections.append(_attribution_section(attribution))
    if ledger is not None:
        for benchmark, fingerprint in ledger.keys():
            runs = ledger.series(benchmark, fingerprint)
            if runs:
                sections.append(_trend_section(benchmark, fingerprint, runs,
                                               confidence))
    if trials:
        sections.append(_trials_section(list(trials), max_trial_rows))
    if skipped:
        items = "".join(f"<li><code>{_esc(fp)}</code>: {_esc(reason)}</li>"
                        for fp, reason in skipped)
        sections.append(f"<h2>Skipped fingerprints</h2><ul>{items}</ul>")
    if not sections:
        sections.append("<p>Nothing to render: no reports, ledger series, "
                        "or verdicts supplied.</p>")
    n_series = len(ledger.keys()) if ledger is not None else 0
    default_sub = (f"{len(list(reports))} fingerprint report(s), "
                   f"{n_series} ledger series.")
    template = string.Template(_TEMPLATE_PATH.read_text(encoding="utf-8"))
    return template.substitute(title=_esc(title),
                               subtitle=_esc(subtitle or default_sub),
                               body="\n".join(sections))


def write_dashboard(path, reports: Sequence = (),
                    skipped: Sequence[tuple[str, str]] = (),
                    ledger: Optional[RunLedger] = None,
                    title: str = "Performance history dashboard",
                    subtitle: Optional[str] = None,
                    confidence: float = 0.99,
                    trials: Sequence[dict] = (),
                    attribution=None,
                    max_trial_rows: int = _MAX_TRIAL_ROWS) -> Path:
    """The CLI recipe shared by ``roofline_report --html`` and
    ``bench.run --html``: detect regressions over the ledger
    (when one is given), render, write. Returns the written path."""
    regression = (detect_regressions(ledger, confidence=confidence)
                  if ledger is not None else None)
    html = render_html(reports, skipped, ledger=ledger,
                       regression=regression, title=title,
                       subtitle=subtitle, confidence=confidence,
                       trials=trials, attribution=attribution,
                       max_trial_rows=max_trial_rows)
    out = Path(path)
    out.write_text(html, encoding="utf-8")
    return out
