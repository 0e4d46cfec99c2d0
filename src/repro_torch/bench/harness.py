"""Harness self-benchmark: how fast is the measurement loop itself?

    python -m repro_torch.bench.harness [--out PATH] [--device cpu]
    python -m repro_torch.bench.harness --check --out PATH   # validate a JSON

The paper's search-time wins come from cutting sample counts; this
module watches the next term — *per-trial harness overhead*. A tuning
campaign evaluates each configuration for the first time, so every
session here runs over configs whose shapes this process has never
seen, once through each harness generation:

  legacy  the port's idiom before the steady sampler: the DGEMM
          invocation factory with fresh seeded numpy operands drawn and
          moved to the device every invocation, one
          ``torch.cuda.synchronize`` per timed sample
          (``timed_sampler``), no background precompile
  fast    ``dgemm_invocation_factory(sampler="steady", reuse_data=True)``:
          operands drawn once per config, batched ``steady_sampler``
          observations (B launches, one synchronize), and the tuner's
          precompile pipeline resolving the next config's kernel while
          the current one measures

and reports the **non-measured wall time per trial**::

    non_measured = session_wall - measured_s
    measured_s   = dispatch + sync phase-bucket seconds

where the *measured* seconds are exactly the samplers' own timed
windows, recorded by :class:`repro_torch.core.PhaseProfiler` from inside
``timed_sampler``/``steady_sampler``. Everything else the session spent
— setup, data generation, transfers, pre-heats, bookkeeping — is
non-measured overhead. Both terms come from the same session, so the
accounting needs no external per-kernel reference time.

Each repetition draws a fresh set of cold shapes; legacy and fast get
interleaved, disjoint shape sets of the same size class. The per-mode
result is the median across repetitions. The JAX package's thresholds
are kept and reported in the JSON (``checks``):

  * non-measured wall per trial: fast >= 3x lower than legacy on both
    the synthetic (tiny-kernel) and DGEMM families
  * batched ``steady_sampler`` agrees with unbatched ``timed_sampler``
    within 2% (the paper's error budget) on the JAX package's 2048^3
    DGEMM, on every device (on a card both time on the card's clock, as
    the DGEMM benchmark does there)

``--check`` validates a written JSON (schema + thresholds; no
measurement). The measuring run writes to ``--out`` (default
``build/harness/harness.json``) beside a span trace of itself.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

BENCH_VERSION = 2
DEFAULT_OUT = "build/harness/harness.json"
MIN_SPEEDUP = 3.0        # >= 3x lower non-measured time
MAX_REL_DIFF = 0.02      # paper's 2% error budget for sampler agreement

# Families: (name, fixed dims, k-generator params, steady batch) — the
# JAX package's. k varies per trial so every config is a fresh shape; the
# two modes take interleaved k values from the same progression.
_FAMILIES = [
    # tiny kernel: the harness itself dominates
    ("synthetic", {"n": 64, "m": 64}, {"base": 32, "step": 4}, 64),
    # the paper's DGEMM at host scale: real measurement load per trial
    ("dgemm", {"n": 512, "m": 512}, {"base": 160, "step": 16}, 8),
]
_CONFIGS_PER_SESSION = 4


def _session_spaces(dims, kgen, rep):
    """Disjoint, interleaved fresh-shape grids for (legacy, fast) at one
    repetition: 8 fresh k values, evens to legacy, odds to fast."""
    from ..core import grid
    lo = rep * 2 * _CONFIGS_PER_SESSION
    ks = [kgen["base"] + kgen["step"] * (lo + j)
          for j in range(2 * _CONFIGS_PER_SESSION)]
    legacy = grid(n=(dims["n"],), m=(dims["m"],), k=tuple(ks[0::2]))
    fast = grid(n=(dims["n"],), m=(dims["m"],), k=tuple(ks[1::2]))
    return legacy, fast


class _LegacyBenchmark:
    """The legacy factory: fresh operands every invocation, one sync per
    timed sample, and no ``precompile`` (so no background pipeline)."""

    def __init__(self, device: str):
        self.device = device

    def __call__(self, cfg: dict):
        from .common import dgemm_invocation_factory
        return dgemm_invocation_factory(cfg["n"], cfg["m"], cfg["k"],
                                        device=self.device)


def _fast_benchmark(batch: int, device: str):
    from .common import dgemm_benchmark
    return dgemm_benchmark(device, sampler="steady", batch=batch,
                           reuse_data=True)


def _session(benchmark, space, settings) -> dict:
    """One profiled tuning session. ``non_measured = wall - (dispatch +
    sync)`` subtracts exactly the samplers' own timed windows."""
    from ..core import PhaseProfiler, Tuner

    prof = PhaseProfiler()
    with prof:
        result = Tuner(space, settings).tune(benchmark)
    buckets = prof.to_json()
    measured = sum(buckets.get(p, {}).get("seconds", 0.0)
                   for p in ("dispatch", "sync"))
    wall = result.total_time_s
    trials = len(result.trials)
    return {
        "wall_s": round(wall, 6),
        "measured_s": round(measured, 6),
        "non_measured_s": round(max(wall - measured, 0.0), 6),
        "non_measured_per_trial_s": round(
            max(wall - measured, 0.0) / trials, 6),
        "trials": trials,
        "samples": result.total_samples,
        "n_precompiled": result.n_precompiled,
        "phases": buckets,
    }


def _run_family(dims, kgen, batch, settings, reps, device) -> dict:
    runs = {"legacy": [], "fast": []}
    for rep in range(reps):
        legacy_space, fast_space = _session_spaces(dims, kgen, rep)
        order = [("legacy", _LegacyBenchmark(device), legacy_space),
                 ("fast", _fast_benchmark(batch, device), fast_space)]
        if rep % 2:     # alternate order so drift cannot favour one mode
            order.reverse()
        for mode, benchmark, space in order:
            runs[mode].append(_session(benchmark, space, settings))

    def summarize(rs):
        med = statistics.median(r["non_measured_per_trial_s"] for r in rs)
        pick = min(rs, key=lambda r: abs(r["non_measured_per_trial_s"] - med))
        out = dict(pick)
        out["non_measured_per_trial_s"] = med   # median across repetitions
        out["reps"] = [r["non_measured_per_trial_s"] for r in rs]
        return out

    leg, fst = summarize(runs["legacy"]), summarize(runs["fast"])
    fst["batch"] = batch
    speedup = (leg["non_measured_per_trial_s"]
               / max(fst["non_measured_per_trial_s"], 1e-9))
    return {
        "configs_per_session": _CONFIGS_PER_SESSION,
        "sessions_per_mode": reps,
        "batch": batch,
        "legacy": leg,
        "fast": fst,
        "speedup_non_measured": round(speedup, 2),
    }


def sampler_agreement(device: str = "cuda", n: int = 2048,
                      obs: int = 8, batch: int = 4) -> dict:
    """Batched vs unbatched score on an n^3 DGEMM: both samplers measure
    the same product on the same operands, observations interleaved in
    alternating order so clock drift hits both streams alike. On a card
    both time on the card's clock, as the DGEMM benchmark does there; on
    the host clock the unbatched sampler's bracket also holds the
    product's dispatch and the synchronize's wake-up once a call, which
    a card's 2048^3 product is too short to hide in 2%."""
    import torch

    from ..core import default_cache, steady_sampler, timed_sampler
    from ..core.card_clock import CardClock
    from ..device import resolve_device, synchronizer
    from .common import dgemm_data, dgemm_flops

    dev = resolve_device(device)
    sync = synchronizer(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = dgemm_data(n, n, n, seed=7, device=dev)
    f = default_cache().compile(torch.matmul, (a, b))
    f(a, b)
    sync()                              # warm
    work = dgemm_flops(n, n, n) / 1e9

    def run():
        f(a, b)
        sync()

    if dev.type == "cuda":
        timed = timed_sampler(lambda: f(a, b), work=work,
                              card_clock=CardClock())
        steady = steady_sampler(lambda: f(a, b), work=work, sync=sync,
                                batch=batch, card_clock=CardClock())
    else:
        timed = timed_sampler(run, work=work)
        steady = steady_sampler(lambda: f(a, b), work=work, sync=sync,
                                batch=batch)
    timed(), steady()                   # one warm round each
    t_scores, s_scores = [], []
    for i in range(obs):
        if i % 2:
            s_scores.append(steady())
            t_scores.append(timed())
        else:
            t_scores.append(timed())
            s_scores.append(steady())
    t_med = statistics.median(t_scores)
    s_med = statistics.median(s_scores)
    rel = abs(s_med - t_med) / t_med
    return {"workload": f"dgemm[{n}x{n}x{n}]", "batch": batch,
            "observations": obs,
            "timed_gflops": round(t_med, 3),
            "steady_gflops": round(s_med, 3),
            "rel_diff": round(rel, 5)}


def measure(reps: int = 3, device: str = "cuda") -> dict:
    import torch

    from ..core import Direction, EvaluationSettings
    from ..device import resolve_device, synchronizer
    from .common import dgemm_data

    dev = resolve_device(device)
    # first-use warm-up on sacrificial shapes: the allocator, the BLAS
    # handle and numpy's generator, attributed to neither mode
    a, b = dgemm_data(48, 48, 40, seed=0, device=dev)
    torch.matmul(a, b)
    synchronizer(dev)()

    # fixed-count settings: both modes run the same trial structure
    settings = EvaluationSettings(max_invocations=3, max_iterations=8,
                                  max_time_s=60.0,
                                  direction=Direction.MAXIMIZE)
    families = {}
    for name, dims, kgen, batch in _FAMILIES:
        families[name] = _run_family(dims, kgen, batch, settings, reps,
                                     dev.type)

    agreement = sampler_agreement(dev.type)
    ok = (all(f["speedup_non_measured"] >= MIN_SPEEDUP
              for f in families.values())
          and agreement["rel_diff"] <= MAX_REL_DIFF)
    return {
        "bench_version": BENCH_VERSION,
        "generated_by": "python -m repro_torch.bench.harness",
        "device": dev.type,
        "protocol": ("fresh-shape sessions; non_measured = wall - "
                     "(dispatch + sync phase buckets), i.e. wall minus "
                     "the samplers' own timed windows; median over "
                     "repetitions on disjoint interleaved shape sets"),
        "settings": {"max_invocations": settings.max_invocations,
                     "max_iterations": settings.max_iterations},
        "families": families,
        "agreement": agreement,
        "checks": {"min_speedup": MIN_SPEEDUP,
                   "max_rel_diff": MAX_REL_DIFF, "pass": ok},
    }


# ---------------------------------------------------------------------------
# Reporting / gating
# ---------------------------------------------------------------------------

def render(doc: dict) -> str:
    lines = ["harness self-benchmark:"]
    for name, fam in doc["families"].items():
        leg = fam["legacy"]["non_measured_per_trial_s"] * 1e3
        fst = fam["fast"]["non_measured_per_trial_s"] * 1e3
        lines.append(
            f"  {name:<10s} non-measured/trial: legacy {leg:8.3f} ms  "
            f"fast {fst:8.3f} ms  ({fam['speedup_non_measured']:.1f}x, "
            f"B={fam['batch']})")
    agr = doc["agreement"]
    lines.append(
        f"  agreement  timed {agr['timed_gflops']:.1f} vs steady "
        f"{agr['steady_gflops']:.1f} GFLOP/s on {agr['workload']} "
        f"(rel diff {agr['rel_diff'] * 100:.2f}%)")
    checks = doc["checks"]
    lines.append(
        f"  targets    >={checks['min_speedup']:g}x speedup, "
        f"<={checks['max_rel_diff'] * 100:g}% sampler divergence: "
        f"{'PASS' if checks['pass'] else 'FAIL'}")
    return "\n".join(lines)


def check(path: pathlib.Path) -> int:
    """Validate a written JSON: schema + recorded thresholds.
    Deterministic (no measurement)."""
    if not path.exists():
        print(f"error: no harness JSON at {path}", file=sys.stderr)
        return 2
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        print(f"error: {path} is not valid JSON: {e}", file=sys.stderr)
        return 2
    problems = []
    if doc.get("bench_version") != BENCH_VERSION:
        problems.append(f"bench_version != {BENCH_VERSION}")
    fams = doc.get("families", {})
    for required in ("synthetic", "dgemm"):
        if required not in fams:
            problems.append(f"missing family {required!r}")
    for name, fam in fams.items():
        spd = fam.get("speedup_non_measured", 0.0)
        if spd < MIN_SPEEDUP:
            problems.append(
                f"{name}: speedup {spd} < required {MIN_SPEEDUP}")
        for mode in ("legacy", "fast"):
            if "non_measured_per_trial_s" not in fam.get(mode, {}):
                problems.append(f"{name}.{mode}: missing accounting")
    rel = doc.get("agreement", {}).get("rel_diff")
    if rel is None or rel > MAX_REL_DIFF:
        problems.append(f"sampler agreement rel_diff {rel} > {MAX_REL_DIFF}")
    if not doc.get("checks", {}).get("pass"):
        problems.append("checks.pass is not true")
    if problems:
        print(f"harness JSON {path}: FAIL")
        for p in problems:
            print(f"  - {p}")
        return 1
    spds = ", ".join(f"{n} {fam['speedup_non_measured']}x"
                     for n, fam in fams.items())
    print(f"harness JSON {path}: ok ({spds}; "
          f"agreement {rel * 100:.2f}%)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.harness", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=DEFAULT_OUT, metavar="PATH",
                    help=f"JSON path (default {DEFAULT_OUT})")
    ap.add_argument("--check", action="store_true",
                    help="validate an existing JSON instead of measuring")
    ap.add_argument("--reps", type=int, default=3,
                    help="fresh-shape sessions per mode (median taken)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sessions run (default: cuda; raises "
                         "when no card is visible)")
    args = ap.parse_args(argv)

    path = pathlib.Path(args.out)
    if args.check:
        return check(path)

    # the measuring run is itself traced: every session's trial,
    # invocation and phase spans land in one JSONL + Chrome trace next to
    # the JSON
    from ..obs import TraceRecorder, write_chrome_trace
    path.parent.mkdir(parents=True, exist_ok=True)
    trace_path = path.with_name(path.stem + ".trace.jsonl")
    trace_path.unlink(missing_ok=True)   # append-only file: one run each
    with TraceRecorder(trace_path, session="bench-harness") as rec:
        doc = measure(reps=args.reps, device=args.device)
    chrome = write_chrome_trace(
        path.with_name(path.stem + ".perfetto.json"), rec.events())
    path.write_text(json.dumps(doc, indent=2, sort_keys=False) + "\n",
                    encoding="utf-8")
    print(render(doc))
    print(f"wrote {path}")
    print(f"wrote {trace_path} and {chrome}")
    return 0 if doc["checks"]["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
