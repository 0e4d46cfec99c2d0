"""The port's observability layer against the JAX package's: the span
trace of the same session, the Chrome-trace export and its validator, the
per-trial summaries, and on-device timing (``torch.profiler``): ``None``
on the host, the exact sum of a trace's CUDA kernel events, and a raise
where the card launched kernels the profiler did not record."""

import dataclasses
import json

import pytest

import repro.core as ref
import repro.obs as ref_obs
import repro_torch.core as port
import repro_torch.obs as port_obs
from repro_torch.obs import device_timing


def quadratic(cfg):
    mu = 100.0 - (cfg["x"] - 5) ** 2

    def factory():
        return lambda: mu

    return factory


def _settings(mod, **kw):
    return mod.EvaluationSettings(max_invocations=2, max_iterations=10,
                                  use_ci_convergence=True,
                                  use_inner_prune=True, use_outer_prune=True,
                                  **kw)


def _traced(mod, obs, backend=None, **settings_kw):
    with obs.TraceRecorder(session="s") as rec:
        mod.Tuner(mod.grid(x=tuple(range(9))), _settings(mod, **settings_kw)
                  ).tune(quadratic, validate="off", pipeline="off",
                         backend=backend)
    return rec.events()


def _structure(events):
    """Span names, categories and parent chains (by name), instant names
    with their parent's name, in emission order; no timings or ids."""
    spans = {e["id"]: e for e in events if e["type"] == "span"}

    def chain(pid):
        out = []
        while pid is not None:
            out.append((spans[pid]["name"], spans[pid]["cat"]))
            pid = spans[pid]["parent"]
        return tuple(out)

    return [(e["type"], e["name"], e.get("cat"), chain(e["parent"]),
             tuple(sorted((e.get("attrs") or {}).keys())))
            for e in events if e["type"] in ("span", "instant")]


@pytest.mark.parametrize("backend", ["serial", "simulated"])
def test_same_session_gives_the_same_trace_structure(backend):
    make = {"serial": lambda m: m.SerialBackend(),
            "simulated": lambda m: m.SimulatedShardedBackend(3)}[backend]
    ours = _traced(port, port_obs, backend=make(port))
    theirs = _traced(ref, ref_obs, backend=make(ref))
    assert _structure(ours) == _structure(theirs)
    assert [e["type"] for e in ours] == [e["type"] for e in theirs]
    names = {e["name"] for e in ours if e["type"] == "instant"}
    assert "incumbent_improved" in names


def test_exports_validate_under_both_packages():
    ours = _traced(port, port_obs)
    theirs = _traced(ref, ref_obs)
    for events in (ours, theirs):
        assert port_obs.to_chrome_trace(events) == \
            ref_obs.to_chrome_trace(events)
        for exporter in (port_obs.to_chrome_trace, ref_obs.to_chrome_trace):
            doc = exporter(events)
            assert port_obs.validate_chrome_trace(doc) == []
            assert ref_obs.validate_chrome_trace(doc) == []
    broken = {"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "pid": 1,
                               "tid": 1, "dur": -1}]}
    assert port_obs.validate_chrome_trace(broken) == \
        ref_obs.validate_chrome_trace(broken) != []


def _untimed(rows):
    drop = {"ts", "dur_s", "tid", "thread"}
    return [{k: (sorted(v) if k == "phases" else v)
             for k, v in r.items() if k not in drop} for r in rows]


def test_trial_summaries_agree():
    ours = _traced(port, port_obs)
    theirs = _traced(ref, ref_obs)
    assert port_obs.trial_summaries(ours) == ref_obs.trial_summaries(ours)
    assert port_obs.trial_summaries(theirs) == \
        ref_obs.trial_summaries(theirs)
    rows = _untimed(port_obs.trial_summaries(ours))
    assert rows == _untimed(ref_obs.trial_summaries(theirs))
    assert [r["index"] for r in rows] == list(range(9))
    assert any(r["improved"] for r in rows)


def test_session_trace_file_and_cache_hits(tmp_path):
    tuner = port.Tuner(port.grid(x=tuple(range(9))), _settings(port))
    session = port.TuningSession("s", tuner, quadratic, cache_dir=tmp_path,
                                 fingerprint="fp", trace=True)
    result = session.run()
    path = tmp_path / "s.trace.jsonl"
    assert result.trace_path == str(path)
    events = port_obs.load_events(path)
    assert port_obs.validate_chrome_trace(
        port_obs.to_chrome_trace(events)) == []
    assert len(port_obs.trial_summaries(events)) == 9
    again = port.TuningSession("s", tuner, quadratic, cache_dir=tmp_path,
                               fingerprint="fp", trace=True).run()
    assert again.n_cached == 9
    hits = [e for e in port_obs.load_events(path)
            if e.get("name") == "cache_hit"]
    assert len(hits) == 9


def test_profile_sample_returns_none_on_the_host():
    import torch
    assert device_timing.device_timing_available() is False
    assert port_obs.profile_sample(lambda: sum(range(100))) is None
    assert port_obs.profile_ops(
        lambda: torch.ones(64, 64) @ torch.ones(64, 64)) is None


def test_evaluator_emits_device_timing_unavailable_on_the_host(tmp_path):
    for mod, obs in ((port, port_obs), (ref, ref_obs)):
        settings = dataclasses.replace(_settings(mod), device_timing=True)
        with obs.TraceRecorder(tmp_path / f"{mod.__name__}.jsonl") as rec:
            mod.Tuner(mod.grid(x=(5,)), settings).tune(quadratic,
                                                       validate="off")
        names = {e["name"] for e in rec.events() if e["type"] == "instant"}
        assert "device_timing_unavailable" in names
        assert "device_timing" not in names


def test_device_timing_skipped_without_recorder(monkeypatch):
    def never(*_a, **_k):
        raise AssertionError("profiled without a recorder")

    monkeypatch.setattr(device_timing, "profile_sample", never)
    settings = dataclasses.replace(_settings(port), device_timing=True)
    result = port.Tuner(port.grid(x=(4, 5)), settings).tune(quadratic)
    assert result.best_score == pytest.approx(100.0)


def _canned_trace() -> dict:
    """A torch.profiler Chrome trace as ``export_chrome_trace`` writes it
    for one window: a primer kernel, then the measured call inside the
    MARK range; host ops, runtime and driver calls, kernels (linked to
    their launches by ``correlation``), a copy, a memset, flow events."""
    def ev(cat, name, ts, dur, corr=None, **kw):
        args = {} if corr is None else {"correlation": corr}
        return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": 7,
                "ts": ts, "dur": dur, "args": args, **kw}

    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python"}},
        ev("cuda_runtime", "cudaLaunchKernel", 2.0, 3.0, corr=1),
        ev("kernel", "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32",
           5.0, 800.0, corr=1, pid=0),
        ev("user_annotation", device_timing.MARK, 810.0, 1200.0),
        ev("gpu_user_annotation", device_timing.MARK, 815.0, 1100.0, pid=0),
        ev("cpu_op", "aten::mm", 812.0, 40.0),
        ev("cuda_runtime", "cudaLaunchKernel", 814.0, 5.0, corr=2),
        ev("kernel", "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32",
           820.0, 812.5, corr=2, pid=0),
        ev("cuda_driver", "cuLaunchKernel", 860.0, 4.0, corr=3),
        ev("kernel", "void triad_vec_kernel<float>(float const*, float "
           "const*, float*, long, float)", 1700.0, 91.25, corr=3, pid=0),
        ev("cuda_runtime", "cudaLaunchKernel", 870.0, 4.0, corr=4),
        ev("kernel", "triad_vec_kernel", 1800.0, 1.5, corr=4, pid=0),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 815.0, 300.0,
           corr=5, pid=0, tid=8),
        ev("gpu_memset", "Memset (Device)", 1.0, 2.0, pid=0, tid=8),
        ev("cuda_runtime", "cudaDeviceSynchronize", 880.0, 950.0, corr=6),
        {"ph": "s", "id": 2, "cat": "ac2g", "name": "ac2g", "pid": 7,
         "tid": 7, "ts": 814.0},
        {"ph": "f", "id": 2, "cat": "ac2g", "name": "ac2g", "pid": 0,
         "tid": 7, "ts": 820.0, "bp": "e"},
    ]}


def test_parser_sums_exactly_the_kernel_events(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_canned_trace()), encoding="utf-8")
    doc = json.loads(path.read_text(encoding="utf-8"))
    ops = device_timing.parse_trace(doc, str(path), device_timing.MARK)
    assert ops.n_events == 3
    assert ops.total_s == (812.5 + 91.25 + 1.5) * 1e-6
    assert ops.by_name == {
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32":
            812.5 * 1e-6,
        "triad_vec_kernel": 91.25 * 1e-6 + 1.5 * 1e-6}
    assert ops.source == str(path)
    # without the mark every kernel of the window counts, primer included
    whole = device_timing.parse_trace(doc)
    assert whole.n_events == 4
    assert whole.total_s == (800.0 + 812.5 + 91.25 + 1.5) * 1e-6
    with pytest.raises(ValueError, match="no 'other' range"):
        device_timing.parse_trace(doc, mark="other")


def test_parser_leaves_out_the_card_clocks_hold(tmp_path):
    """A CardClock sample's spin kernel, launched inside a HOLD_MARK range
    within the measured call, is not the sample's device time."""
    from repro_torch.core.card_clock import HOLD_MARK

    doc = _canned_trace()
    doc["traceEvents"] += [
        {"ph": "X", "cat": "user_annotation", "name": HOLD_MARK, "pid": 7,
         "tid": 7, "ts": 811.0, "dur": 2.5, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 7, "tid": 7, "ts": 811.5, "dur": 1.5,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel(long)",
         "pid": 0, "tid": 7, "ts": 812.0, "dur": 60.0,
         "args": {"correlation": 9}}]
    ops = device_timing.parse_trace(doc, mark=device_timing.MARK)
    assert ops.n_events == 3
    assert ops.total_s == (812.5 + 91.25 + 1.5) * 1e-6
    assert device_timing.parse_trace(doc).by_name[
        "at::cuda::spin_kernel"] == 60.0 * 1e-6


def test_parser_counts_only_the_card_clocks_last_try():
    """A CardClock sample retaken under the profiler leaves two tries in
    the window, each a hold and a product: the last try is the sample."""
    from repro_torch.core.card_clock import HOLD_MARK, TRY_MARK

    def ev(cat, name, ts, dur, corr=None, pid=7):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": 7,
                "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}

    events = [ev("user_annotation", device_timing.MARK, 0.0, 2000.0)]
    for i, t in enumerate((10.0, 900.0)):
        events += [
            ev("user_annotation", TRY_MARK, t, 60.0),
            ev("user_annotation", HOLD_MARK, t + 1.0, 5.0),
            ev("cuda_runtime", "cudaLaunchKernel", t + 2.0, 2.0, 10 * i + 1),
            ev("kernel", "at::cuda::spin_kernel(long)", t + 4.0, 40.0,
               10 * i + 1, pid=0),
            ev("cuda_runtime", "cudaLaunchKernel", t + 20.0, 20.0, 10 * i + 2),
            ev("kernel", "cutlass::Kernel2<sgemm>(Params)", t + 60.0,
               340.0 + i, 10 * i + 2, pid=0)]
    doc = {"traceEvents": events}
    ops = device_timing.parse_trace(doc, mark=device_timing.MARK)
    assert ops.n_events == 1
    assert ops.by_name == {"cutlass::Kernel2": 341.0 * 1e-6}
    # every launch in the range has its kernel: nothing lost
    assert device_timing._lost_records(doc) == 0


def test_kernel_names_drop_signature_and_templates():
    norm = device_timing.normalize_op_name
    assert norm("void at::native::vectorized_elementwise_kernel<4, "
                "at::native::FillFunctor<float>, std::array<char*, 1ul> >"
                "(int, at::native::FillFunctor<float>, std::array<char*, "
                "1ul>)") == "at::native::vectorized_elementwise_kernel"
    assert norm("void (anonymous namespace)::k<(int)3>(float*)") == "k"
    assert norm("ampere_sgemm_128x64_nn") == "ampere_sgemm_128x64_nn"


def test_host_only_trace_is_none_and_lost_kernel_track_raises():
    doc = _canned_trace()
    host_only = {"traceEvents": [e for e in doc["traceEvents"]
                                 if e.get("cat") == "cpu_op"]}
    assert device_timing.parse_trace(host_only) is None
    lost = {"traceEvents": [e for e in doc["traceEvents"]
                            if e.get("cat") != "kernel"]}
    with pytest.raises(device_timing.DeviceTimingError, match="no kernel"):
        device_timing.parse_trace(lost, mark=device_timing.MARK)
    # the primer's kernel does not stand in for the measured call's
    warm_only = {"traceEvents": [
        e for e in doc["traceEvents"]
        if e.get("cat") != "kernel" or e["args"]["correlation"] == 1]}
    with pytest.raises(device_timing.DeviceTimingError):
        device_timing.parse_trace(warm_only, mark=device_timing.MARK)
    # one of the measured call's three kernels lost: no short sum of the rest
    part = {"traceEvents": [
        e for e in doc["traceEvents"]
        if e.get("cat") != "kernel" or e["args"]["correlation"] != 3]}
    with pytest.raises(device_timing.DeviceTimingError,
                       match=r"1 of the 3 launches .* \[3\]"):
        device_timing.parse_trace(part, mark=device_timing.MARK)


def _windows(monkeypatch, docs):
    """Serve ``docs`` as successive profiler windows; returns the count of
    windows taken."""
    taken = []

    def collect(fn, root):
        fn()
        taken.append(root)
        return docs[len(taken) - 1], 1e-3, "canned"

    monkeypatch.setattr(device_timing, "_collect_trace", collect)
    return taken


def test_cuda_launch_without_kernel_event_raises(monkeypatch, tmp_path):
    doc = _canned_trace()
    lost = {"traceEvents": [e for e in doc["traceEvents"]
                            if e.get("cat") != "kernel"]}
    part = {"traceEvents": [
        e for e in doc["traceEvents"]
        if e.get("cat") != "kernel" or e["args"]["correlation"] != 4]}
    for window in (lost, part):
        taken = _windows(monkeypatch, [window, doc])
        with pytest.raises(device_timing.DeviceTimingError):
            port_obs.profile_sample(lambda: None)
        assert len(taken) == 1      # raised at once: no second window
    _windows(monkeypatch, [lost])
    # the evaluator has no fallback either: the error reaches the caller
    settings = dataclasses.replace(_settings(port), device_timing=True)
    with port_obs.TraceRecorder(tmp_path / "t.jsonl"):
        with pytest.raises(device_timing.DeviceTimingError):
            port.Tuner(port.grid(x=(5,)), settings).tune(quadratic)


def test_profiled_kernels_give_device_timing(monkeypatch, tmp_path):
    monkeypatch.setattr(device_timing, "_collect_trace",
                        lambda fn, root: (fn(), _canned_trace(), 2e-3,
                                          "canned")[1:])
    counters = port_obs.metrics().snapshot()["counters"]
    before = counters.get("device_timing.lost_kernel_records", 0)
    timing = port_obs.profile_sample(lambda: None)
    assert timing.n_events == 3
    assert timing.skew_s == pytest.approx(2e-3 - timing.device_time_s)
    # the 3 launches of the MARK range all have their kernel records
    assert port_obs.metrics().snapshot()["counters"][
        "device_timing.lost_kernel_records"] == before
    settings = dataclasses.replace(_settings(port), device_timing=True)
    with port_obs.TraceRecorder(tmp_path / "t.jsonl") as rec:
        result = port.Tuner(port.grid(x=(3, 5, 4)), settings).tune(quadratic)
    instants = [e for e in rec.events() if e.get("name") == "device_timing"]
    # profiled only where the trial beat the incumbent
    assert len(instants) == len(result.improvements) == 2
    assert instants[0]["attrs"]["host_time_s"] == 2e-3


def test_sampler_probe_pairs_launches_with_their_kernels():
    from repro_torch.bench import sampler_probe
    launches, kernels = sampler_probe._launches_kernels(_canned_trace())
    assert [ev["args"]["correlation"] for ev in launches] == [1, 2, 3, 4]
    assert sorted(kernels) == [1, 2, 3, 4]
    assert kernels[3]["dur"] == 91.25
    with pytest.raises(RuntimeError, match="runs on a card"):
        sampler_probe.probe()
