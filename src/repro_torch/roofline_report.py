"""Render roofline dashboards from persisted trial caches — no re-measuring.

    python -m repro_torch.roofline_report .tuning_sessions/nightly.jsonl
    python -m repro_torch.roofline_report .tuning_sessions --csv roofline.csv
    python -m repro_torch.roofline_report .tuning_sessions \\
        --html roofline.html --history .tuning_sessions/history.jsonl

(with ``src`` on ``PYTHONPATH``). Takes one or more cache files (or
directories of ``*.jsonl`` session caches), groups the trials by
benchmark × hardware fingerprint, extracts the DGEMM incumbent (compute
ceiling ``F_p``) and the per-size TRIAD incumbents (memory slopes
``B_a``), and emits a markdown dashboard per fingerprint — measured peaks
with confidence intervals from the stored Welford moments, an ASCII
roofline with achieved-kernel markers, a %-of-roof gap table — plus a
side-by-side comparison across fingerprints; ``--csv`` also writes the
flat CSV. The output is the JAX package's ``scripts/roofline_report.py``
output, byte for byte, on the same caches.

``--html`` additionally writes a **self-contained HTML dashboard** (inline
CSS/JS/SVG, no external deps); with ``--history LEDGER`` it also embeds
per-series trend lines with CI bands and the regression verdicts from the
performance-history ledger; with ``--trace TRACE`` it embeds a per-trial
drill-down table from a session trace (``python -m repro_torch.tune
--trace``). The report reads records only and needs no card.
``--attribute`` (per-op attribution) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from .core import build_reports, load_trials
from .core.report import (DGEMM_BENCHMARK, TRIAD_BENCHMARK, render_csv,
                          render_markdown)

#: flags kept from the JAX CLI whose layer is not ported, and the ROADMAP
#: entry each waits for
UNPORTED = {"attribute": "Observability and lint"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.roofline_report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+",
                    help="cache files or directories of *.jsonl caches")
    ap.add_argument("--dgemm-benchmark", default=DGEMM_BENCHMARK,
                    help="benchmark name supplying the compute peak")
    ap.add_argument("--triad-benchmark", default=TRIAD_BENCHMARK,
                    help="benchmark name supplying the bandwidth slopes")
    ap.add_argument("--confidence", type=float, default=0.99)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the markdown dashboard here (default stdout)")
    ap.add_argument("--csv", default=None, metavar="PATH",
                    help="also write the flat CSV (curves, marks, gaps)")
    ap.add_argument("--html", default=None, metavar="PATH",
                    help="also write a self-contained HTML dashboard "
                         "(inline CSS/JS/SVG, no external deps)")
    ap.add_argument("--history", default=None, metavar="LEDGER",
                    help="run-ledger JSONL to embed trend lines and "
                         "regression verdicts into the --html dashboard")
    ap.add_argument("--trace", default=None, metavar="TRACE",
                    help="session trace JSONL (python -m repro_torch.tune "
                         "--trace) to embed a per-trial drill-down table "
                         "into the --html dashboard")
    ap.add_argument("--max-trial-rows", type=int, default=200,
                    metavar="N",
                    help="row cap of the --trace drill-down table "
                         "(default 200)")
    for flag, entry in UNPORTED.items():
        ap.add_argument(f"--{flag}", default=None,
                        help=f"not ported yet (ROADMAP '{entry}'): raises")
    args = ap.parse_args(argv)
    for flag, entry in UNPORTED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag}: not ported yet (ROADMAP '{entry}')")

    trials = []
    for p in args.paths:
        path = pathlib.Path(p)
        if not path.exists():
            print(f"error: no such cache: {p}", file=sys.stderr)
            return 2
        trials.extend(load_trials(path))
    if not trials:
        print("error: no readable trials in the given cache(s)",
              file=sys.stderr)
        return 1

    reports, skipped = build_reports(
        trials, dgemm_benchmark=args.dgemm_benchmark,
        triad_benchmark=args.triad_benchmark, confidence=args.confidence)
    if not reports:
        # a --history ledger can still carry an HTML trend dashboard even
        # when no fingerprint has roofline-complete (dgemm+triad) trials
        print("no reportable fingerprint — need unpruned trials of "
              f"both {args.dgemm_benchmark!r} and {args.triad_benchmark!r}:",
              file=sys.stderr)
        for fp, reason in skipped:
            print(f"  {fp}: {reason}", file=sys.stderr)
        if not (args.html and args.history):
            print("error: nothing to render", file=sys.stderr)
            return 1

    # in the ledger-only continue-path reports is empty: --out/--csv still
    # write (a header-only dashboard/CSV), never silently skip a requested
    # artifact while exiting 0
    markdown = render_markdown(reports, skipped)
    if args.out:
        pathlib.Path(args.out).write_text(markdown, encoding="utf-8")
        print(f"wrote {args.out}")
    elif reports:
        sys.stdout.write(markdown)
    if args.csv:
        pathlib.Path(args.csv).write_text(render_csv(reports),
                                          encoding="utf-8")
        print(f"wrote {args.csv}")
    if args.html:
        import time

        from .history import RunLedger, write_dashboard

        ledger = None
        if args.history:
            history_path = pathlib.Path(args.history)
            if not history_path.exists():
                print(f"error: no such ledger: {args.history}",
                      file=sys.stderr)
                return 2
            ledger = RunLedger(history_path)
        trial_rows = ()
        if args.trace:
            trace_path = pathlib.Path(args.trace)
            if not trace_path.exists():
                print(f"error: no such trace: {args.trace}",
                      file=sys.stderr)
                return 2
            from .obs import load_events, trial_summaries
            trial_rows = trial_summaries(load_events(trace_path))
        stamp = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())
        write_dashboard(args.html, reports, skipped, ledger=ledger,
                        title="Roofline & performance history",
                        subtitle=f"generated {stamp} from "
                                 f"{len(trials)} cached trials",
                        confidence=args.confidence, trials=trial_rows,
                        max_trial_rows=args.max_trial_rows)
        print(f"wrote {args.html}")
    return 0


if __name__ == "__main__":
    import os

    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout closed early (e.g. piped into `head`) — not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
