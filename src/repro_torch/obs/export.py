"""Trace exports: Chrome trace-event JSON and per-trial summary tables.

:func:`to_chrome_trace` emits the Trace Event Format that both
``chrome://tracing`` and https://ui.perfetto.dev load directly: one
``ph="X"`` complete event per span (``ts``/``dur`` in microseconds),
``ph="i"`` thread-scoped instants, and ``ph="M"`` process/thread name
metadata with ``pid=1`` for the session and ``tid`` = the worker
thread.  Events are sorted by begin time within the array so timestamps
are monotone per tid and enclosing spans precede their children —
:func:`validate_chrome_trace` checks exactly that plus proper nesting.

:func:`trial_summaries` folds a raw event list into one dict per trial
(config, score, prune/stop reason, sample count, per-phase seconds,
improvement marker, worker thread) — the compact per-trial table of a
session trace.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["load_events", "to_chrome_trace", "trial_summaries",
           "validate_chrome_trace", "write_chrome_trace"]

# nesting/monotonicity tolerance: span bounds are rounded to nanoseconds
# on write, so disagreements below ~2us are representation noise
_EPS_US = 2.0


def load_events(path: str | Path) -> list[dict]:
    """Read a trace JSONL file, skipping torn/garbage lines."""
    events: list[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("type"):
                events.append(rec)
    return events


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def to_chrome_trace(events: Iterable[dict], *, pid: int = 1) -> dict:
    """Convert recorder events to a Perfetto-loadable Chrome trace."""
    events = list(events)
    session = next((e.get("session") for e in events
                    if e.get("type") == "meta" and e.get("session")), None)
    out: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": f"session:{session}" if session else "session"},
    }]
    thread_names: dict[int, str] = {}
    body: list[tuple[tuple, dict]] = []
    for e in events:
        kind = e.get("type")
        if kind not in ("span", "instant"):
            continue
        tid = int(e.get("tid", 0))
        if tid not in thread_names:
            thread_names[tid] = str(e.get("thread", tid))
        args = dict(e.get("attrs") or {})
        if kind == "span":
            args["span_id"] = e.get("id")
            if e.get("parent") is not None:
                args["parent"] = e.get("parent")
            ev = {"ph": "X", "name": str(e.get("name")),
                  "cat": str(e.get("cat", "phase")),
                  "ts": _us(float(e.get("ts", 0.0))),
                  "dur": _us(float(e.get("dur", 0.0))),
                  "pid": pid, "tid": tid, "args": args}
            # begin-time order, widest-first on ties: parents precede
            # children and per-tid timestamps come out monotone
            body.append(((ev["ts"], -ev["dur"]), ev))
        else:
            if e.get("parent") is not None:
                args["parent"] = e.get("parent")
            ev = {"ph": "i", "s": "t", "name": str(e.get("name")),
                  "ts": _us(float(e.get("ts", 0.0))),
                  "pid": pid, "tid": tid, "args": args}
            body.append(((ev["ts"], 0.0), ev))
    for tid, name in sorted(thread_names.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}})
    out.extend(ev for _, ev in sorted(body, key=lambda item: item[0]))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str | Path, events: Iterable[dict]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome_trace(events)) + "\n",
                    encoding="utf-8")
    return path


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema/shape problems in an exported trace ([] when clean).

    Checks: required keys per phase type, non-negative durations,
    monotone begin timestamps per tid in array order, and proper
    nesting of duration events within each tid (spans on one thread
    must contain or be disjoint from each other — never interleave).
    """
    problems: list[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    last_ts: dict[int, float] = {}
    open_spans: dict[int, list[tuple[float, float, str]]] = defaultdict(list)
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph not in ("X", "i"):
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        missing = [k for k in ("name", "ts", "pid", "tid") if k not in ev]
        if ph == "X" and "dur" not in ev:
            missing.append("dur")
        if missing:
            problems.append(f"event {i}: missing {missing}")
            continue
        tid = ev["tid"]
        ts = float(ev["ts"])
        if ts < last_ts.get(tid, float("-inf")) - _EPS_US:
            problems.append(
                f"event {i} ({ev['name']}): ts {ts} not monotone on "
                f"tid {tid} (prev {last_ts[tid]})")
        last_ts[tid] = max(ts, last_ts.get(tid, ts))
        if ph != "X":
            continue
        dur = float(ev["dur"])
        if dur < 0:
            problems.append(f"event {i} ({ev['name']}): negative dur {dur}")
            continue
        stack = open_spans[tid]
        while stack and stack[-1][1] <= ts + _EPS_US:
            stack.pop()
        if stack and ts + dur > stack[-1][1] + _EPS_US:
            problems.append(
                f"event {i} ({ev['name']}): [{ts}, {ts + dur}] interleaves "
                f"with open span {stack[-1][2]!r} ending {stack[-1][1]} "
                f"on tid {tid}")
            continue
        stack.append((ts, ts + dur, str(ev["name"])))
    return problems


def trial_summaries(events: Iterable[dict]) -> list[dict]:
    """One compact dict per trial, in trial-index order.

    Fresh trials come from ``cat="trial"`` spans (phase seconds are
    summed over the span's descendants, improvement/prune markers from
    instants inside it); cache-served trials come from ``cache_hit``
    instants and carry ``cached=True`` with no timing breakdown.
    """
    events = list(events)
    spans = [e for e in events if e.get("type") == "span"]
    instants = [e for e in events if e.get("type") == "instant"]
    children: dict[Optional[int], list[dict]] = defaultdict(list)
    for s in spans:
        children[s.get("parent")].append(s)

    rows: list[dict] = []
    for t in spans:
        if t.get("cat") != "trial":
            continue
        attrs = t.get("attrs") or {}
        subtree = {t.get("id")}
        phases: dict[str, float] = {}
        invocations = 0
        frontier = [t]
        while frontier:
            node = frontier.pop()
            for c in children.get(node.get("id"), ()):
                subtree.add(c.get("id"))
                frontier.append(c)
                if c.get("cat") == "invocation":
                    invocations += 1
                elif c.get("cat") == "phase":
                    name = str(c.get("name"))
                    phases[name] = phases.get(name, 0.0) + float(
                        c.get("dur", 0.0))
        # instants attach by parent span (live backends emit them inside
        # the trial span) or by a "trial" attr (round-synchronized
        # backends all-reduce after the spans close)
        marks = [i for i in instants
                 if i.get("parent") in subtree
                 or (i.get("attrs") or {}).get("trial") == attrs.get("index")]
        rows.append({
            "index": attrs.get("index"),
            "config": attrs.get("config"),
            "score": attrs.get("score"),
            "pruned": bool(attrs.get("pruned")),
            "stop_reason": attrs.get("stop_reason"),
            "samples": attrs.get("samples"),
            "worker": attrs.get("worker"),
            "thread": t.get("thread"),
            "tid": t.get("tid"),
            "ts": float(t.get("ts", 0.0)),
            "dur_s": float(t.get("dur", 0.0)),
            "invocations": invocations,
            "phases": dict(sorted(phases.items())),
            "improved": any(i.get("name") == "incumbent_improved"
                            for i in marks),
            "cached": False,
        })
    for i in instants:
        if i.get("name") != "cache_hit":
            continue
        attrs = i.get("attrs") or {}
        rows.append({
            "index": attrs.get("index"),
            "config": attrs.get("config"),
            "score": attrs.get("score"),
            "pruned": bool(attrs.get("pruned")),
            "stop_reason": attrs.get("stop_reason"),
            "samples": attrs.get("samples"),
            "worker": None,
            "thread": i.get("thread"),
            "tid": i.get("tid"),
            "ts": float(i.get("ts", 0.0)),
            "dur_s": 0.0,
            "invocations": 0,
            "phases": {},
            "improved": False,
            "cached": True,
        })
    rows.sort(key=lambda r: (r["index"] is None,
                             r["index"] if r["index"] is not None else 0,
                             r["ts"]))
    return rows
