"""Where one host-timed DGEMM sample's time goes on the card, and which
kernel records a ``torch.profiler`` window loses.

    python -m repro_torch.bench.sampler_probe [--n 2048] [--minutes 3]
                                              [--out FILE.json]

Samplers, on the n^3 f32 product (TF32 off) of the harness's agreement
check, same operands throughout:

- ``variants``: per-product µs of one product and of a B-deep batch, by
  each way of launching (``torch.matmul``, a CUDA graph's replay),
  waiting (``torch.cuda.synchronize``, polling an event) and clocking it
  (host clock, CUDA events with and without a spin kernel holding the
  stream, :class:`~repro_torch.core.card_clock.CardClock`), interleaved;
  the host time a launch takes to return and a wait with nothing queued;
  ``variants_spin_flag`` the same in a fresh process whose CUDA context
  spins while it waits (``cudaDeviceScheduleSpin``);
- ``agreement``: :func:`repro_torch.bench.harness.sampler_agreement` as
  the harness runs it, without and then with a span recorder installed;
- ``gap_sweep``: single synchronized products, as ``timed_sampler``
  brackets them, each after the host has spun a fixed gap with the card
  idle (0 to 10 ms); per gap the median host bracket, launch return
  (host) and product time on the card (CUDA events around the launch);
- ``steady``: B products back to back, one synchronize, with CUDA events
  between them: the host bracket over B and each product's card time;
- ``kernel_dur``: the same single products after each gap, then B-deep
  batches, in one profiler window: each product kernel's own duration,
  free of the launch delay a CUDA event recorded before it includes.

Profiler (``torch.profiler``, CPU + CUDA activity): windows of 64 small
kernels launched, each followed by a synchronize, at process ages from
0 to ``--minutes`` with f32 products keeping the card busy between them,
each as a plain window and as a window with a warm-up step.
Per window: the launches with no kernel record, where they lie (their
launch index and host offset from the window's first launch), and the
offset of each kept kernel's start from its launch's start (negative
means the trace places a kernel before the call that launched it).

It prints, and writes as JSON with ``--out``, the card's name and power
limit (``nvidia-smi``) beside the results. Runs only on a card.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..core.card_clock import CardClock

#: host-side idle gaps before a single timed product, seconds
GAPS_S = (0.0, 20e-6, 100e-6, 1e-3, 10e-3)
#: samples per gap and steady observations
REPS = 16
#: small kernels per profiler window
WINDOW_KERNELS = 64


def _spin(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def _median(xs) -> float:
    return statistics.median(xs)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def gap_sweep(f, a, b, gaps=GAPS_S, reps: int = REPS) -> list[dict]:
    """Single synchronized products after a host spin of each gap: host
    bracket, launch return and card time (CUDA events), medians in µs."""
    rows = []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for gap in gaps:
        host, launch, device = [], [], []
        for _ in range(reps):
            _spin(gap)
            t0 = time.perf_counter()
            e0.record()
            f(a, b)
            e1.record()
            tl = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host.append((t1 - t0) * 1e6)
            launch.append((tl - t0) * 1e6)
            device.append(e0.elapsed_time(e1) * 1e3)
        rows.append({"gap_us": gap * 1e6, "host_us": _median(host),
                     "launch_us": _median(launch),
                     "device_us": _median(device),
                     "wait_us": _median(h - d for h, d in zip(host, device))})
    return rows


def steady(f, a, b, batch: int = 4, reps: int = REPS) -> dict:
    """B products back to back and one synchronize: host bracket over B,
    and each product's card time (CUDA events between launches)."""
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(batch + 1)]
    host, device, first = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        evs[0].record()
        for j in range(batch):
            f(a, b)
            evs[j + 1].record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host.append((t1 - t0) * 1e6 / batch)
        per = [evs[j].elapsed_time(evs[j + 1]) * 1e3 for j in range(batch)]
        first.append(per[0])
        device.extend(per[1:])
    return {"batch": batch, "host_us_per_product": _median(host),
            "device_us_first": _median(first),
            "device_us_rest": _median(device)}


def _event_wait(ev) -> None:
    """Wait for the work queued so far by polling an event just recorded
    behind it, instead of ``torch.cuda.synchronize``."""
    ev.record()
    while not ev.query():
        pass


def _graph(f, a, b):
    """The product captured once as a CUDA graph (fixed operands)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        f(a, b)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        f(a, b)
    g.replay()
    torch.cuda.synchronize()
    return g


def variants(f, a, b, obs: int = 16, batch: int = 4,
             block_us: float = 300.0) -> dict:
    """Per-product µs (medians) of one product, or of a B-deep batch, by
    each way of launching, waiting and clocking it; every variant takes
    its observations interleaved with the others'."""
    g = _graph(f, a, b)
    ev = torch.cuda.Event()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    cycles = int(block_us * 1e-6 * 1.98e9)

    def launch():
        f(a, b)

    def host(kernel, wait, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            kernel()
        wait()
        return (time.perf_counter() - t0) * 1e6 / reps

    def device(kernel, reps, blocked):
        if blocked:                  # hold the stream until all is queued
            torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(reps):
            kernel()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) * 1e3 / reps

    def ret(kernel):                 # host time until the launch returns
        t0 = time.perf_counter()
        kernel()
        t = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        return t

    def idle(wait):                  # a wait with nothing queued
        t0 = time.perf_counter()
        wait()
        return (time.perf_counter() - t0) * 1e6

    sync = torch.cuda.synchronize
    spin = functools.partial(_event_wait, ev)
    card1, cardb = CardClock(), CardClock()
    runs = {
        "timed_matmul_sync": lambda: host(launch, sync, 1),
        "timed_matmul_event": lambda: host(launch, spin, 1),
        "timed_graph_sync": lambda: host(g.replay, sync, 1),
        "timed_graph_event": lambda: host(g.replay, spin, 1),
        "steady_matmul_sync": lambda: host(launch, sync, batch),
        "steady_matmul_event": lambda: host(launch, spin, batch),
        "steady_graph_event": lambda: host(g.replay, spin, batch),
        "events_single": lambda: device(launch, 1, False),
        "events_single_blocked": lambda: device(launch, 1, True),
        "events_batch_blocked": lambda: device(launch, batch, True),
        "card_clock_single": lambda: card1.measure(launch) * 1e6,
        "card_clock_batch": lambda: cardb.measure(
            lambda: [launch() for _ in range(batch)]) * 1e6 / batch,
        "return_matmul": lambda: ret(launch),
        "return_graph": lambda: ret(g.replay),
        "idle_sync": lambda: idle(sync),
        "idle_event": lambda: idle(spin),
    }
    vals: dict[str, list] = {k: [] for k in runs}
    for _ in range(2):               # warm
        for run in runs.values():
            run()
    for i in range(obs):
        names = list(runs) if i % 2 == 0 else list(reversed(runs))
        for name in names:
            vals[name].append(runs[name]())
    return {"batch": batch, "block_us": block_us, "obs": obs,
            **{k: round(_median(v), 3) for k, v in vals.items()},
            "min": {k: round(min(v), 3) for k, v in vals.items()}}


def spin_flag_variants(n: int) -> dict:
    """:func:`variants` in a fresh process whose CUDA context was made
    with ``cudaDeviceScheduleSpin``."""
    import sys
    code = ("import ctypes, json, torch\n"
            "rc = ctypes.CDLL('libcudart.so.12').cudaSetDeviceFlags(1)\n"
            "from repro_torch.bench.sampler_probe import _variants_at\n"
            f"print(json.dumps({{'set_flags_rc': rc, **_variants_at({n})}}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    if p.returncode != 0:
        return {"error": p.stderr[-2000:]}
    return json.loads(p.stdout.strip().splitlines()[-1])


def _variants_at(n: int) -> dict:
    from .common import dgemm_data
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = dgemm_data(n, n, n, seed=7, device="cuda")
    torch.matmul(a, b)
    torch.cuda.synchronize()
    return variants(torch.matmul, a, b)


def kernel_durations(f, a, b, gaps=GAPS_S, reps: int = 8,
                     batch: int = 4) -> dict:
    """Product kernels' own durations (``torch.profiler``), median µs:
    single synchronized products after each gap, and B-deep batches."""
    from torch.profiler import ProfilerActivity, profile

    plan = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for gap in gaps:
            for _ in range(reps):
                _spin(gap)
                f(a, b)
                torch.cuda.synchronize()
                plan.append(f"gap_{gap * 1e6:g}us")
        for _ in range(reps):
            for j in range(batch):
                f(a, b)
                plan.append("steady_first" if j == 0 else "steady_rest")
            torch.cuda.synchronize()
    launches, kernels = _launches_kernels(_export(prof))
    durs: dict[str, list] = {}
    for label, ev in zip(plan, launches[-len(plan):]):
        k = kernels.get((ev.get("args") or {}).get("correlation"))
        if k is not None:
            durs.setdefault(label, []).append(float(k["dur"]))
    return {label: {"median_us": _median(v), "n": len(v)}
            for label, v in durs.items()}


def _export(prof) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "w.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text(encoding="utf-8"))


def _launches_kernels(doc: dict) -> tuple[list, dict]:
    """A trace's launch calls in host order, and its kernels by their
    launches' correlation id."""
    from ..obs.device_timing import _is_launch

    events = [e for e in doc["traceEvents"]
              if isinstance(e, dict) and e.get("ph") == "X"]
    launches = sorted((e for e in events if _is_launch(e)),
                      key=lambda e: float(e["ts"]))
    kernels = {(e.get("args") or {}).get("correlation"): e for e in events
               if str(e.get("cat", "")).lower() == "kernel"}
    return launches, kernels


def samplers(n: int) -> dict:
    from ..core import default_cache
    from ..obs import TraceRecorder
    from .common import dgemm_data
    from .harness import sampler_agreement

    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = dgemm_data(n, n, n, seed=7, device="cuda")
    f = default_cache().compile(torch.matmul, (a, b))
    f(a, b)
    torch.cuda.synchronize()
    out = {"n": n, "variants": variants(f, a, b),
           "variants_spin_flag": spin_flag_variants(n)}
    print(json.dumps(out, indent=1), flush=True)
    out["agreement"] = sampler_agreement("cuda", n=n)
    with tempfile.TemporaryDirectory() as tmp:
        with TraceRecorder(Path(tmp) / "t.jsonl", session="probe"):
            out["agreement_traced"] = sampler_agreement("cuda", n=n)
    out["gap_sweep"] = gap_sweep(f, a, b)
    out["steady"] = steady(f, a, b)
    out["kernel_dur"] = kernel_durations(f, a, b)
    return out


def _window(warmup: bool = False) -> dict:
    """One profiler window of WINDOW_KERNELS small kernels, each followed
    by a synchronize; what its trace kept. ``warmup``: the window is a
    schedule of one warm-up step (the tracer starts there, WINDOW_KERNELS
    kernels) and one recorded step, as ``obs/device_timing.py`` opens
    its windows."""
    from torch.profiler import ProfilerActivity, profile, schedule

    x = torch.zeros(1024, device="cuda")
    kw = ({"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}
          if warmup else {})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], **kw) as prof:
        if warmup:
            for _ in range(WINDOW_KERNELS):
                x.add_(1.0)
            torch.cuda.synchronize()
            prof.step()
        for _ in range(WINDOW_KERNELS):
            x.add_(1.0)
            torch.cuda.synchronize()
        if warmup:
            prof.step()
    launches, kernels = _launches_kernels(_export(prof))
    t_first = float(launches[0]["ts"]) if launches else 0.0
    lost, offsets = [], []
    for i, ev in enumerate(launches):
        k = kernels.get((ev.get("args") or {}).get("correlation"))
        if k is None:
            lost.append((i, float(ev["ts"]) - t_first))
        else:
            offsets.append(float(k["ts"]) - float(ev["ts"]))
    return {"launches": len(launches), "kernels": len(kernels),
            "lost": len(lost), "lost_index": [i for i, _ in lost],
            "lost_host_offset_us": [round(t, 3) for _, t in lost],
            "kept_first_host_offset_us": (
                round(min(float(e["ts"]) - t_first for e in launches
                          if (e.get("args") or {}).get("correlation")
                          in kernels), 3) if offsets else None),
            "kernel_minus_launch_us": (
                {"min": round(min(offsets), 3),
                 "median": round(_median(offsets), 3)}
                if offsets else None)}


def profiler(minutes: float, n: int = 4096) -> list[dict]:
    """Windows at process ages 0 .. ``minutes``, products between them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(n, n, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    t_start = time.perf_counter()
    rows = []
    ages = sorted({0.0, *(minutes * 60 * j / 6 for j in range(1, 7))})
    for age in ages:
        while time.perf_counter() - t_start < age:
            for _ in range(32):
                torch.matmul(a, a)
            torch.cuda.synchronize()
        for warmup in (False, True):
            row = _window(warmup)
            row["warmup_step"] = warmup
            row["age_s"] = round(time.perf_counter() - t_start, 1)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def probe(n: int = 2048, minutes: float = 3.0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("sampler_probe runs on a card: "
                           "torch.cuda.is_available() is False")
    report = {"card": _card(), "torch": torch.__version__}
    report["samplers"] = samplers(n)
    print(json.dumps(report["samplers"], indent=1), flush=True)
    report["profiler"] = profiler(minutes)
    report["card_after"] = _card()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args(argv)
    report = probe(args.n, args.minutes)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text, encoding="utf-8")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
