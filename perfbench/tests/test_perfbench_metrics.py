"""The metric arithmetic on synthetic spans, counters and profiler
events: the trace reduction (busy time, idle gaps by host range, the
top device operations) and each per-layer reader."""

import collections
import types

import pytest

from perfbench.lib import counts, peaks, spec
from perfbench.lib.trace import reduce_events

MS = 1_000_000  # ns


def test_reduce_events_busy_idle_and_breakdown():
    device = [("gemm", 1 * MS, 4 * MS), ("gemm", 3 * MS, 5 * MS),
              ("copy", 7 * MS, 8 * MS), ("outside", 20 * MS, 30 * MS)]
    host = [("outer", 0, 10 * MS), ("aten::mm", 5 * MS, 7 * MS)]
    t = reduce_events(device, host, (0, 10 * MS))
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.005)          # [1, 5] and [7, 8]
    assert t.device_ops == [["gemm", pytest.approx(0.005)],
                            ["copy", pytest.approx(0.001)]]
    idle = dict(t.idle_gaps)
    # [0, 1] and [8, 10] under "outer", [5, 7] under the innermost mm
    assert idle["outer"] == pytest.approx(0.003)
    assert idle["aten::mm"] == pytest.approx(0.002)
    assert len(t.kernels) == 3


def test_a_hold_of_the_stream_is_idle():
    """The card clock's spin kernel waits for the host: not busy, and its
    time is labelled by what the host was running."""
    device = [("at::cuda::(anonymous namespace)::spin_kernel(long)", 0,
               2 * MS), ("gemm", 2 * MS, 3 * MS)]
    host = [("card_clock.try", 0, 2 * MS)]
    t = reduce_events(device, host, (0, 4 * MS))
    assert t.busy_s == pytest.approx(0.001)
    assert dict(t.idle_gaps)["card_clock.try"] == pytest.approx(0.002)
    assert dict(t.device_ops)["gemm"] == pytest.approx(0.001)
    assert len(t.device_ops) == 2


def test_reduce_events_clips_to_the_window():
    t = reduce_events([("k", -5 * MS, 2 * MS)], [], (0, 4 * MS))
    assert t.busy_s == pytest.approx(0.002)
    assert t.idle_gaps == [["no host range", pytest.approx(0.002)]]


def _run(records, trace=None, traffic=None, config=None, model=None):
    cell = types.SimpleNamespace(traffic=traffic or {}, config=config or {})
    return types.SimpleNamespace(records=records, trace=trace, cell=cell,
                                 model=model or {}, window_s=2.0)


def test_tuner_readers():
    sessions = [{"samples": 10, "wall_s": 1.0, "sample_s": 0.5},
                {"samples": 30, "wall_s": 2.0, "sample_s": 1.7}]
    run = _run({"sessions": sessions})
    assert spec.metric_reader("samples_per_session").read(run) == 20
    assert spec.metric_reader("host_ms_per_sample").read(run) == \
        pytest.approx((0.5 + 0.3) / 40 * 1e3)
    assert spec.metric_reader("samples_per_session").read(_run({})) is None


def test_gemm_roofline_reads_the_winners_kernels():
    kernels = [("void matmul_f32_sm90_kernel<64, 128, 32>(x)", 0, 2e-3),
               ("void matmul_f32_sm90_kernel<64, 128, 32>(x)", 0, 4e-3),
               ("void matmul_f32_sm90_kernel<128, 64, 32>(x)", 0, 9e-3),
               ("other", 0, 1.0)]
    trace = types.SimpleNamespace(kernels=kernels)
    run = _run({"winners": collections.Counter({(64, 128, 32): 1})}, trace,
               traffic={"tokens": 4096, "n": "N", "k": "K"},
               config={"N": 8192, "K": 2048})
    bound = peaks.bound_s(counts.gemm_flops(4096, 8192, 2048),
                          counts.gemm_bytes(4096, 8192, 2048),
                          peaks.F32_ACCURATE_FLOPS)
    got = spec.metric_reader("gemm_f32_roofline").read(run)
    assert got == pytest.approx(100 * bound / 3e-3)
    run.records["winners"] = collections.Counter({(256, 256, 8): 2})
    assert spec.metric_reader("gemm_f32_roofline").read(run) is None


def test_idle_share():
    trace = types.SimpleNamespace(window_s=2.0, busy_s=1.5)
    for name in ("idle_share.tune", "idle_share.serve",
                 "idle_share.decode"):
        assert spec.metric_reader(name).read(_run({}, trace)) == \
            pytest.approx(25.0)
        assert spec.metric_reader(name).read(_run({})) is None


GRANITE = {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
           "n_kv_heads": 2, "d_ff": 128, "vocab_size": 512}


def test_serving_readers_on_batches():
    batches = [{"prefill_s": 0.2, "decode_s": 0.3},
               {"prefill_s": 0.4, "decode_s": 0.6}]
    traffic = {"kind": "generate", "batch": 2, "prompt_len": 16, "gen": 4}
    run = _run({"batches": batches}, traffic=traffic, model=GRANITE)
    assert spec.metric_reader("prefill_ms").read(run) == pytest.approx(300)
    for name in ("decode_ms_per_step", "decode_ms_per_step.serve"):
        assert spec.metric_reader(name).read(run) == \
            pytest.approx(0.9 / 6 * 1e3)
    flops = counts.prefill_flops(GRANITE, 2, 16) + sum(
        counts.decode_step_flops(GRANITE, 2, 16 + i) for i in range(3))
    assert spec.metric_reader("mfu.serve").read(run) == pytest.approx(
        100 * 2 * flops / 2.0 / peaks.BF16_FLOPS)


def test_serving_readers_on_rounds():
    rounds = [{"seconds": 0.8}, {"seconds": 1.2}]
    traffic = {"kind": "decode", "batch": 2, "context": 24, "steps": 4}
    run = _run({"rounds": rounds}, traffic=traffic, model=GRANITE)
    assert spec.metric_reader("decode_ms_per_step").read(run) == \
        pytest.approx(2.0 / 8 * 1e3)
    assert spec.metric_reader("prefill_ms").read(run) is None
    flops = sum(counts.decode_step_flops(GRANITE, 2, 24 + i)
                for i in range(4))
    assert spec.metric_reader("mfu.decode").read(run) == pytest.approx(
        100 * 2 * flops / 2.0 / peaks.BF16_FLOPS)
