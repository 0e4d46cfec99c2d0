"""The card's own clock around work queued on the current CUDA stream.

On a card, a host clock around ``launch + torch.cuda.synchronize`` also
times the launch call and the synchronize's return: on an H100 a 2048^3
f32 product's launch returns after 15-250 µs and the synchronize adds
7-100 µs, against a 340 µs kernel (``python -m
repro_torch.bench.sampler_probe``), so one host-timed sample reads
4-25% under the kernel's rate. A B-deep batch pays that cost once for B
kernels, so a batched and an unbatched sampler disagree by about as much.

:class:`CardClock` times a sample between two CUDA events recorded on
the stream around the queued work. Events alone do not remove the
dispatch: on an idle stream the start event fires at once and the card
then waits for the host to finish the launch. So a spin kernel
(``torch.cuda._sleep``) first holds the stream while the host queues the
start event, the work and the end event; when the hold ends the card
runs them back to back, and the bracket holds the work's device time
alone. The hold's length follows the host: 1.5x the time the last sample
took to queue, plus :data:`HOLD_MARGIN_S`. A sample whose queueing took
longer than the hold (timed against the hold's own device time) is taken
again with a hold twice that long; each such retry counts in the
``card_clock.retries`` metric.

Under ``torch.profiler`` each try queues inside a ``record_function``
range named :data:`TRY_MARK`, and its hold inside one named
:data:`HOLD_MARK`: :mod:`repro_torch.obs.device_timing` counts only the
last try's kernels, its hold left out, as the sample's device time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

__all__ = ["CardClock", "HOLD_MARK", "TRY_MARK"]

#: ``record_function`` ranges, while profiling, around each try's
#: queueing and around its hold kernel
TRY_MARK = "repro_torch.card_clock.try"
HOLD_MARK = "repro_torch.card_clock.hold"
#: the first hold, the shortest, and the margin added to 1.5x the last
#: queueing time
FIRST_HOLD_S = 100e-6
MIN_HOLD_S = 20e-6
HOLD_MARGIN_S = 5e-6
#: holds tried for one sample before giving up
MAX_TRIES = 8


class CardClock:
    """Device seconds of the work one ``enqueue()`` call queues on the
    current CUDA stream, with the host's dispatch held out of the bracket.

    ``enqueue`` must only queue work: a synchronize inside it would put
    the host's wake-up between the events. :meth:`measure` synchronizes
    once, after the end event. One clock serves one sampler at a time.
    """

    def __init__(self):
        import torch

        self._hold_s = FIRST_HOLD_S
        self._cycles_per_s = 2.0e9       # first guess; measured every hold
        self._events = [torch.cuda.Event(enable_timing=True)
                        for _ in range(3)]
        #: host seconds the last measured sample took to queue
        self.queued_s = 0.0
        self.retries = 0

    def measure(self, enqueue: Callable[[], Any]) -> float:
        import torch

        from ..obs.metrics import metrics

        hold_start, start, end = self._events
        if torch.autograd._profiler_enabled():
            mark = torch.autograd.profiler.record_function
        else:
            mark = _no_mark
        for _ in range(MAX_TRIES):
            cycles = max(int(self._hold_s * self._cycles_per_s), 1)
            with mark(TRY_MARK):
                t0 = time.perf_counter()
                hold_start.record()
                with mark(HOLD_MARK):
                    torch.cuda._sleep(cycles)
                start.record()
                enqueue()
                end.record()
                queued = time.perf_counter() - t0
            torch.cuda.synchronize()
            held = hold_start.elapsed_time(start) * 1e-3
            if held > 0.0:
                self._cycles_per_s = cycles / held
            if queued <= held:
                self.queued_s = queued
                self._hold_s = max(MIN_HOLD_S, 1.5 * queued + HOLD_MARGIN_S)
                return max(start.elapsed_time(end) * 1e-3, 1e-12)
            self.retries += 1
            metrics().inc("card_clock.retries")
            self._hold_s = 2.0 * queued
        raise RuntimeError(
            f"the host took {queued * 1e6:.1f} µs to queue one sample, "
            f"longer than each of {MAX_TRIES} holds of the stream (the last "
            f"{held * 1e6:.1f} µs): the card's clock would time the dispatch")


def _no_mark(_name: str):
    return contextlib.nullcontext()
