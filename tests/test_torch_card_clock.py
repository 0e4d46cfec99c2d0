"""The card clock's logic on a simulated stream (the host has no card).

A fake CUDA stream runs each queued op once the host has queued it (plus
a fixed launch latency) and the op before it has finished; events take
the stream's time. The clock must return the work's device time alone,
retake a sample whose hold ended before the host had queued it, and feed
the samplers' scores and phases.
"""

import pytest
import torch

import repro_torch.core as port
from repro_torch.core import card_clock as cc
from repro_torch.obs.metrics import metrics

LATENCY = 4e-6        # host queue -> card sees the op
RATE = 1.98e9         # spin-kernel cycles per second


class _Card:
    def __init__(self):
        self.host = 0.0
        self.stream = 0.0

    def queue(self, seconds: float) -> float:
        start = max(self.stream, self.host + LATENCY)
        self.stream = start + seconds
        return self.stream


@pytest.fixture
def card(monkeypatch):
    sim = _Card()

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = sim.queue(0.0)

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    class Clock:
        @staticmethod
        def perf_counter():
            return sim.host

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: sim.queue(cycles / RATE))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: setattr(sim, "host",
                                        max(sim.host, sim.stream)))
    monkeypatch.setattr(cc, "time", Clock)
    return sim


def _work(sim, host_s, device_s):
    def enqueue():
        sim.host += host_s             # the launch call's host time
        sim.queue(device_s)
    return enqueue


def test_card_clock_times_the_work_not_the_dispatch(card):
    clock = cc.CardClock()
    for _ in range(3):
        assert clock.measure(_work(card, 30e-6, 340e-6)) == \
            pytest.approx(340e-6, rel=1e-9)
    assert clock.retries == 0
    assert clock.queued_s == pytest.approx(30e-6)
    # what a host bracket around queue + synchronize would read
    t0 = card.host
    _work(card, 30e-6, 340e-6)()
    torch.cuda.synchronize()
    assert card.host - t0 > 340e-6 + 30e-6


def test_card_clock_retakes_a_sample_the_hold_did_not_cover(card):
    before = metrics().counter("card_clock.retries")
    clock = cc.CardClock()             # first hold: 100 µs
    assert clock.measure(_work(card, 250e-6, 340e-6)) == \
        pytest.approx(340e-6, rel=1e-9)
    assert clock.retries == 1
    assert metrics().counter("card_clock.retries") == before + 1


def test_card_clock_raises_when_no_hold_covers_the_queueing(card):
    clock = cc.CardClock()
    cost = [100e-6]

    def enqueue():                     # each try queues 4x slower
        cost[0] *= 4
        card.host += cost[0]
        card.queue(1e-6)

    with pytest.raises(RuntimeError, match="to queue one sample"):
        clock.measure(enqueue)
    assert clock.retries == cc.MAX_TRIES


def test_samplers_score_the_card_time(card):
    prof = port.PhaseProfiler()
    with prof:
        timed = port.timed_sampler(_work(card, 30e-6, 340e-6), work=17.0,
                                   card_clock=cc.CardClock())
        assert timed() == pytest.approx(17.0 / 340e-6, rel=1e-9)
        steady = port.steady_sampler(
            lambda: _work(card, 30e-6, 340e-6)(), work=17.0,
            sync=lambda h=None: None, batch=4, card_clock=cc.CardClock())
        assert steady.batch == 4
        assert steady() == pytest.approx(17.0 / 340e-6, rel=1e-9)
    buckets = prof.to_json()
    assert buckets["dispatch"]["count"] == 2
    assert buckets["sync"]["count"] == 1
