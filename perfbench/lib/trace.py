"""The traced run's device trace: ``torch.profiler`` (CPU and CUDA
activities) over the measured window, reduced to what the metrics and
``breakdown`` read.

* ``window_s``: the traced window, the span of the ``perfbench.window``
  range the harness records around the measured work;
* ``busy_s``: the union of the device's operations (kernels, copies,
  sets) inside it (one chip), holds left out: a hold (``spin_kernel``,
  ``torch.cuda._sleep``, which the card clock queues to keep the stream
  waiting while the host queues a sample) does no work, so its time is
  idle, labelled like any other gap;
* ``kernels``: each device operation's name, start and seconds;
* ``breakdown``: the ten device operations that took most time, and the
  idle time (the window less ``busy_s``) by what the host was running at
  each idle gap's middle (the innermost CPU range that covers it).
"""

from __future__ import annotations

import contextlib
import heapq
import dataclasses
from collections import defaultdict
from typing import Iterator, Optional

__all__ = ["HOLD_OPS", "Trace", "WINDOW_MARK", "profiled", "reduce_events"]

WINDOW_MARK = "perfbench.window"
#: device operations that only hold the stream (matched in the name)
HOLD_OPS = ("spin_kernel",)
_NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list                 # (name, start_s, seconds)
    device_ops: list              # [name, seconds], ten at most
    idle_gaps: list               # [host activity, seconds], ten at most


def _union(intervals: list) -> list:
    out: list = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def reduce_events(device: list, host: list, window: tuple) -> Trace:
    """``device``: (name, start_ns, end_ns) of device operations;
    ``host``: (name, start_ns, end_ns) of CPU ranges; ``window``: (start,
    end) ns."""
    w0, w1 = window
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    busy = _union([(a, b) for n, a, b in inside
                   if not any(h in n for h in HOLD_OPS)])
    busy_ns = sum(b - a for a, b in busy)
    per_op: dict = defaultdict(float)
    for name, a, b in inside:
        per_op[name[:_NAME_CHARS]] += (b - a) * 1e-9
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi > lo:
            gaps.append((lo, hi))
    # one sweep over the gaps' middles in order: the host ranges begun
    # by each middle sit in a heap by start, latest first; one that has
    # ended by then has ended for every later middle too
    host = sorted((a, b, n) for n, a, b in host)
    begun: list = []
    nxt = 0
    idle: dict = defaultdict(float)
    for lo, hi in gaps:
        mid = (lo + hi) // 2
        while nxt < len(host) and host[nxt][0] <= mid:
            a, b, name = host[nxt]
            heapq.heappush(begun, (-a, b, name))
            nxt += 1
        while begun and begun[0][1] < mid:
            heapq.heappop(begun)
        label = begun[0][2][:_NAME_CHARS] if begun else "no host range"
        idle[label] += (hi - lo) * 1e-9

    def top(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                 kernels=[(n, a * 1e-9, (b - a) * 1e-9)
                          for n, a, b in inside],
                 device_ops=top(per_op), idle_gaps=top(idle))


def _from_profiler(prof) -> Trace:
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if "CUDA" in str(ev.device_type()):
            # a ``record_function`` range has a device-side twin: not work
            if not ev.is_user_annotation():
                device.append((name, start, end))
        elif name == WINDOW_MARK:
            window = (start, end)
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_MARK!r} range")
    return reduce_events(device, host, window)


class _Holder:
    trace: Optional[Trace] = None


@contextlib.contextmanager
def profiled(on: bool) -> Iterator[_Holder]:
    """Profile the block when ``on``; the holder's ``trace`` is set when
    the block ends. The block must synchronize the device before it
    ends, so that its last kernels fall inside the window."""
    import torch
    holder = _Holder()
    if not on:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_MARK):
            yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    holder.trace = _from_profiler(prof)
