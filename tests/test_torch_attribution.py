"""The port's roofline attribution (``repro_torch.obs.attribution``), its
per-op counter (``repro_torch.analysis.ops.count_ops``), the hand
kernels' ``torch.library`` ops, the profiler's per-op join, and the CLIs
that reach them (``roofline_report --attribute``, ``tune --live
--validate``), against the JAX package's attribution where both take the
same input."""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.analysis.hlo as ref_hlo
import repro.obs.attribution as ref_attr
import repro.obs.device_timing as ref_dt
import repro_torch.analysis.ops as port_ops
import repro_torch.obs.attribution as port_attr
import repro_torch.obs.device_timing as port_dt
from repro_torch import kernels
from repro_torch.analysis import count_ops
from repro_torch.kernels import registry

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = [(ref_attr, ref_hlo), (port_attr, port_ops)]
IDS = ["ref", "port"]


def roofs(attr):
    """Handmade roofs with easy arithmetic: ridge at I* = 100/10 = 10."""
    return attr.Roofs(peak_flops=100.0, bandwidths={"hbm": 10.0, "l2": 40.0},
                      fingerprint="test-roofs")


def _op(ops, name, kind, flops, bytes_accessed, modeled=True):
    return ops.OpCost(name=name, kind=kind, flops=flops,
                      bytes_accessed=bytes_accessed, modeled=modeled)


# ---------------------------------------------------------------------------
# Roofs and the per-op math, through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attr,ops", PACKAGES, ids=IDS)
def test_roofs(attr, ops):
    r = roofs(attr)
    assert r.default_subsystem == "hbm"
    assert r.ridge() == pytest.approx(10.0)
    assert r.ridge("l2") == pytest.approx(2.5)
    assert r.attainable(2.0) == pytest.approx(20.0)
    assert r.attainable(50.0) == pytest.approx(100.0)
    assert r.attainable(2.0, "l2") == pytest.approx(80.0)
    assert r.classify(20.0) == ("hbm", "compute")
    assert r.classify(1.0) == ("hbm", "memory")
    assert r.classify(10.0) == ("hbm", "compute")
    assert r.model_time(50.0, 100.0) == pytest.approx(10.0)
    assert r.model_time(80.0, 1.0) == pytest.approx(0.8)
    assert r.to_json() == {"peak_flops": 100.0,
                           "bandwidths": {"hbm": 10.0, "l2": 40.0},
                           "fingerprint": "test-roofs"}


@pytest.mark.parametrize("attr,ops", PACKAGES, ids=IDS)
def test_attr_op_math(attr, ops):
    r = roofs(attr)
    a = attr._attr_op(_op(ops, "mm", "mm", 200.0, 10.0), 2.0, r, static=True)
    assert (a.pct_of_roof, a.bound, a.subsystem) == (100.0, "compute", "hbm")
    a = attr._attr_op(_op(ops, "mm", "mm", 200.0, 10.0), 4.0, r,
                      static=False)
    assert a.pct_of_roof == pytest.approx(50.0)
    b = attr._attr_op(_op(ops, "f", "mul", 5.0, 100.0), 20.0, r,
                      static=False)
    assert b.bound == "memory" and b.pct_of_roof == pytest.approx(50.0)
    c = attr._attr_op(_op(ops, "c", "copy", 0.0, 50.0), 10.0, r,
                      static=False)
    assert c.pct_of_roof == pytest.approx(50.0)
    no_time = attr._attr_op(_op(ops, "d", "mm", 8.0, 4.0), None, r,
                            static=False)
    assert no_time.pct_of_roof is None and no_time.subsystem == "hbm"
    no_roofs = attr._attr_op(_op(ops, "d", "mm", 8.0, 4.0), 1.0, None,
                             static=False)
    assert (no_roofs.subsystem, no_roofs.bound) == ("unclassified",
                                                    "unclassified")
    inf = attr._attr_op(_op(ops, "x", "exp", 4.0, 0.0), 1.0, r, static=False)
    assert math.isinf(inf.intensity) and inf.to_json()["intensity"] is None


def test_pct_of_roof_is_not_clamped():
    """A tensor-core op can beat an f32 DGEMM roof: reported as is."""
    a = port_attr._attr_op(_op(port_ops, "f", "repro_torch::flash", 1e6,
                               1.0), 1e-6, roofs(port_attr), static=False)
    assert a.pct_of_roof == pytest.approx(100.0 * (1e6 / 1e-6) / 100.0)


def _module(ops, unhandled=None):
    return ops.ModuleOps(ops=(
        _op(ops, "dot.1", "dot", 200.0, 10.0),
        _op(ops, "fusion.2", "fusion", 5.0, 100.0),
        _op(ops, "copy.3", "copy", 0.0, 50.0),
        _op(ops, "custom-call.4", "custom-call", 0.0, 0.0, modeled=False),
    ), unhandled=unhandled or {"custom-call": 1})


def test_static_report_equals_the_reference_s_field_by_field():
    ours = port_attr.attribution_from_static(
        "train_step", _module(port_ops), roofs(port_attr), fingerprint="fp")
    ref = ref_attr.attribution_from_static(
        "train_step", _module(ref_hlo), roofs(ref_attr), fingerprint="fp")
    assert ours.to_json() == ref.to_json()
    assert ours.to_markdown() == ref.to_markdown()
    assert ours.to_markdown(max_ops=2) == ref.to_markdown(max_ops=2)
    for a, b in zip(ours.ops, ref.ops):
        assert a.to_json() == b.to_json()
    assert (ours.unattributed_s, ours.unattributed_frac) == (0.0, 0.0)
    assert ours.attributed_s == pytest.approx(
        sum(op.time_s for op in ours.ops))
    no_roofs = port_attr.attribution_from_static("w", _module(port_ops),
                                                 None)
    assert all(op.subsystem == "unclassified" for op in no_roofs.ops)
    assert json.dumps(no_roofs.to_json()) and no_roofs.to_markdown()


def test_measured_report_equals_the_reference_s():
    """The port joins by ``DeviceOps.by_op``, the reference by
    ``by_name``; on the same times the reports agree."""
    times = {"dot.1": 4.0, "fusion.2": 2.0, "unmatched-kernel": 1.0}
    ours = port_attr._attribution_from_device(
        "w", _module(port_ops), port_dt.DeviceOps(
            total_s=10.0, by_name={}, n_events=4, source="t", by_op=times),
        roofs(port_attr))
    ref = ref_attr._attribution_from_device(
        "w", _module(ref_hlo), ref_dt.DeviceOps(
            total_s=10.0, by_name=times, n_events=4, source="t"),
        roofs(ref_attr))
    assert ours.to_json() == ref.to_json()
    assert ours.unattributed_s == pytest.approx(4.0)
    assert ours.subsystem_seconds == {"compute": pytest.approx(4.0),
                                      "hbm": pytest.approx(2.0)}
    assert [o.name for o in ours.top_ops(2)] == ["dot.1", "fusion.2"]
    clamped = port_attr._attribution_from_device(
        "w", _module(port_ops), port_dt.DeviceOps(
            total_s=1.0, by_name={}, n_events=1, source="t",
            by_op={"dot.1": 2.0}), roofs(port_attr))
    assert clamped.unattributed_s == 0.0


def test_dashboard_section_is_the_reference_s(golden):
    from repro.history.render import render_html as ref_render
    from repro_torch.history.render import render_html
    r = {"hbm": 1.0e8, "l2": 4.0e8}
    reports = []
    for attr, ops in PACKAGES:
        module = ops.ModuleOps(ops=(
            _op(ops, "dot.1", "dot", 2.0e6, 4.0e4),
            _op(ops, "fusion.2", "fusion", 1.0e3, 2.0e5),
            _op(ops, "copy.3", "copy", 0.0, 8.0e4),
            _op(ops, "custom-call.4", "custom-call", 0.0, 0.0,
                modeled=False)), unhandled={"custom-call": 1})
        reports.append(attr.attribution_from_static(
            "train_step", module, attr.Roofs(1.0e9, r, "golden-fp"),
            fingerprint="golden-fp"))
    kw = dict(title="Attribution test dashboard",
              subtitle="fixed subtitle for golden stability")
    html = render_html(attribution=reports[1], **kw)
    assert html == ref_render(attribution=reports[0], **kw)
    golden("attribution.html", html)


# ---------------------------------------------------------------------------
# Roofs from the trial cache
# ---------------------------------------------------------------------------


def _seed_cache(path):
    from test_report import synthetic_trials
    from repro_torch.core import TrialCache
    for t in synthetic_trials():
        TrialCache(path, fingerprint=t.fingerprint).put(t.benchmark,
                                                        t.config, t.result)


def test_roofs_from_trials(tmp_path):
    path = tmp_path / "c.jsonl"
    _seed_cache(path)
    r = port_attr.roofs_from_trials([str(path)], fingerprint="fpB")
    want = ref_attr.roofs_from_trials([str(path)], fingerprint="fpB")
    assert r.to_json() == want.to_json()
    assert r.peak_flops == pytest.approx(900.0e9)
    assert port_attr.roofs_from_trials([str(path)]).fingerprint in (
        "fpA", "fpB")
    assert port_attr.roofs_from_trials([str(tmp_path / "none")]) is None
    (tmp_path / "empty.jsonl").write_text("")
    assert port_attr.roofs_from_trials([str(tmp_path / "empty.jsonl")]) \
        is None


# ---------------------------------------------------------------------------
# Static attribution of real workloads (the host's mode)
# ---------------------------------------------------------------------------


def test_dgemm_attributed_flops_match_declared():
    from repro_torch.models.workloads import build_workload
    w = build_workload("dgemm", m=64, n=48, k=32, device="cpu")
    rep = port_attr.attribute(w, roofs(port_attr), force_static=True)
    assert rep.total_flops == pytest.approx(w.declared_flops, rel=0.01)
    assert [(op.name, op.flops) for op in rep.ops] == \
        [("aten::mm#0", 2.0 * 64 * 48 * 32)]
    assert rep.ops[0].bytes_accessed == 4 * (64 * 32 + 32 * 48 + 64 * 48)


def test_train_step_static_attribution_matches_its_work_term():
    """Every op of the tiny dense train step is labeled; the total FLOPs
    lie within 1% of the family's work term (the same registry counts
    both on the plain path); the remainder is exactly 0."""
    from repro_torch.models.workloads import build_workload, workload_flops
    w = build_workload("train_step", device="cpu")
    rep = port_attr.attribute(w, roofs(port_attr))     # host: static
    assert rep.mode == "static" and rep.device_total_s is None
    assert rep.total_flops == pytest.approx(workload_flops(w), rel=0.01)
    assert rep.unattributed_s == 0.0
    for op in rep.ops:
        assert op.subsystem in ("hbm", "l2")
        assert op.pct_of_roof is not None
    names = [op.name for op in rep.ops]
    assert len(set(names)) == len(names)
    assert {op.kind for op in rep.ops if op.flops > 0} == {"aten::bmm"}


def test_card_attribution_without_a_kernel_raises(monkeypatch):
    """On the card there is no fallback: a profiler window without a
    kernel raises instead of degrading to the static report."""
    from repro_torch.models.workloads import build_workload
    w = build_workload("dgemm", m=8, n=8, k=8, device="cpu")
    monkeypatch.setattr(port_attr, "_device",
                        lambda workload: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(port_dt, "profile_ops",
                        lambda fn, log_dir=None: fn())
    with pytest.raises(port_dt.DeviceTimingError, match="no kernel"):
        port_attr.attribute(w, roofs(port_attr))


def test_attribution_emits_trace_instants(tmp_path):
    from repro_torch.models.workloads import build_workload
    from repro_torch.obs import TraceRecorder, load_events
    w = build_workload("dgemm", m=16, n=16, k=16, device="cpu")
    with TraceRecorder(tmp_path / "t.jsonl"):
        port_attr.attribute(w, roofs(port_attr))
    names = [e.get("name") for e in load_events(tmp_path / "t.jsonl")]
    assert "attribution" in names and "attribution_op" in names


# ---------------------------------------------------------------------------
# count_ops
# ---------------------------------------------------------------------------


def test_count_ops_records_names_bytes_and_skips_views():
    a = torch.ones(4, 8)
    b = torch.ones(8, 3)

    def fn(a, b):
        c = a @ b
        d = c.t().contiguous()                   # view, then a copy
        e = torch.empty(5)                      # allocation only
        return d * 2.0 + c.sum(), e

    module = count_ops(fn, (a, b))
    kinds = [o.kind for o in module.ops]
    assert "aten::t" not in kinds and "aten::view" not in kinds
    by = module.by_name()
    assert by["aten::mm#0"].flops == 2 * 4 * 8 * 3
    assert by["aten::mm#0"].bytes_accessed == 4 * (32 + 24 + 12)
    assert by["aten::clone#0"].flops == 0
    assert by["aten::clone#0"].bytes_accessed == 4 * (12 + 12)
    assert by["aten::empty#0"].modeled is False
    assert module.unhandled == {"aten::empty": 1}
    assert by["aten::mm#0"].intensity == pytest.approx(
        by["aten::mm#0"].flops / by["aten::mm#0"].bytes_accessed)


def test_count_ops_occurrences_and_write_only_destinations():
    x = torch.ones(16)

    def fn(x):
        y = x + 1.0
        z = y + 2.0
        w = torch.empty_like(z)
        w.copy_(z)
        return w

    module = count_ops(fn, (x,))
    assert [o.name for o in module.ops] == [
        "aten::add#0", "aten::add#1", "aten::empty_like#0", "aten::copy_#0"]
    assert module.by_name()["aten::copy_#0"].bytes_accessed == 2 * 64


def test_count_ops_on_meta_allocates_nothing():
    from repro_torch.models.workloads import TINY_CONFIG, meta_step
    fn, args = meta_step(TINY_CONFIG, 2, 64)
    module = count_ops(fn, args)
    assert module.flops > 0 and module.bytes_accessed > 0


# ---------------------------------------------------------------------------
# The hand kernels' ops: fake, formula, CPU routing
# ---------------------------------------------------------------------------


def _cases(device):
    gen = np.random.default_rng(19)

    def t(*shape):
        return torch.from_numpy(
            gen.standard_normal(shape).astype(np.float32)).to(device)

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import flops as fa_flops
    from repro_torch.kernels.matmul import flops as mm_flops
    from repro_torch.kernels.matmul import matmul_ref
    from repro_torch.kernels.ssd import needed_flops, ssd_chunk_scan_ref
    from repro_torch.kernels.triad import flops as triad_flops
    from repro_torch.kernels.triad import triad_ref
    a, b = t(300), t(300)
    ma, mb = t(33, 17), t(17, 9)
    q, kv = t(1, 4, 50, 16), t(1, 2, 50, 16)
    xdt, bm, cm = t(1, 2, 3, 8, 4), t(1, 3, 8, 5), t(1, 3, 8, 5)
    cum = -torch.rand(1, 2, 3, 8, generator=torch.Generator().manual_seed(
        1)).cumsum(-1).to(device)
    return {
        "triad": ((a, b, 2.5), triad_flops(300), (300,),
                  lambda: triad_ref(a, b, 2.5)),
        "matmul": ((ma, mb, 64, 64, 8), mm_flops(33, 9, 17), (33, 9),
                   lambda: matmul_ref(ma, mb)),
        "flash_attention_fwd": (
            (q, kv, kv, 0.25, True, None, 64, 64),
            fa_flops(1, 4, 50, 16, True), (1, 4, 50, 16),
            lambda: attention_ref(q, kv, kv, sm_scale=0.25, causal=True)),
        "ssd_chunk_scan_fwd": (
            (xdt, bm, cm, cum, None, True), needed_flops(1, 2, 24, 8, 4, 5),
            (1, 2, 3, 8, 4),
            lambda: ssd_chunk_scan_ref(xdt, bm, cm, cum,
                                       return_state=True)[0]),
    }


@pytest.mark.parametrize("name", sorted(registry.OPS))
def test_op_fake_formula_and_cpu_routing(name):
    op = registry.OPS[name]
    assert str(op) == f"repro_torch.{name}.default"
    args, formula, shape, plain = _cases("cpu")[name]
    kernels.reset_launch_counts()
    with FlopCounterMode(display=False) as counter:
        out = op(*args)
    y = out[0] if isinstance(out, tuple) else out
    assert counter.get_total_flops() == formula
    assert tuple(y.shape) == shape
    torch.testing.assert_close(y, plain(), rtol=0, atol=0)
    assert sum(kernels.launch_counts().values()) == 0
    meta_args = tuple(x.to("meta") if isinstance(x, torch.Tensor) else x
                      for x in args)
    with FlopCounterMode(display=False) as counter:
        fake = op(*meta_args)
    fy = fake[0] if isinstance(fake, tuple) else fake
    assert fy.device.type == "meta" and tuple(fy.shape) == shape
    assert counter.get_total_flops() == formula
    module = count_ops(op, meta_args)
    assert [(o.kind, o.flops) for o in module.ops] == \
        [(f"repro_torch::{name}", formula)]


def test_ssd_op_state_output_is_empty_unless_asked():
    args = _cases("cpu")["ssd_chunk_scan_fwd"][0]
    y, h = registry.OPS["ssd_chunk_scan_fwd"](*args[:5], False)
    assert h.numel() == 0
    y, h = registry.OPS["ssd_chunk_scan_fwd"](*(
        x.to("meta") if isinstance(x, torch.Tensor) else x
        for x in args[:5]), True)
    assert tuple(h.shape) == (1, 2, 4, 5)


@pytest.mark.parametrize("wrapper,args,kwargs,op", [
    ("triad", ((300,), (300,)), {}, "triad"),
    ("matmul", ((33, 17), (17, 9)), {"bm": 64, "bn": 64, "bk": 8}, "matmul"),
    ("flash_attention", ((1, 4, 50, 16), (1, 2, 50, 16), (1, 2, 50, 16)),
     {"bq": 64, "bk": 64}, "flash_attention_fwd"),
])
def test_wrappers_dispatch_one_op(wrapper, args, kwargs, op):
    fn = getattr(kernels, wrapper)
    tensors = [torch.empty(s, device="meta") for s in args]
    module = count_ops(lambda: fn(*tensors, **kwargs))
    assert [o.kind for o in module.ops] == [f"repro_torch::{op}"]


def test_wrappers_refuse_other_devices():
    from repro_torch.kernels.triad import triad
    x = torch.ones(4)

    class Fake:
        type = "xpu"

    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        registry.check_device("triad", Fake())
    assert triad(x, x).shape == (4,)


# ---------------------------------------------------------------------------
# The profiler's per-op join (synthetic traces)
# ---------------------------------------------------------------------------


def _ev(name, cat, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
          "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_join_charges_each_kernel_to_the_op_that_launched_it():
    mark = port_dt.MARK
    doc = {"traceEvents": [
        _ev(mark, "user_annotation", 0, 1000),
        _ev("aten::mm#0", "user_annotation", 10, 100),
        _ev("aten::mm", "cpu_op", 12, 90),
        _ev("cudaLaunchKernel", "cuda_runtime", 50, 5, corr=1),
        _ev("repro_torch::triad#0", "user_annotation", 200, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 250, 5, corr=2),
        # the backward thread's op
        _ev("aten::mm#1", "user_annotation", 400, 100, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 450, 5, tid=2, corr=3),
        # a launch outside every op's range
        _ev("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=4),
        _ev("void gemm<float>(float*)", "kernel", 60, 30, corr=1),
        _ev("triad_vec_kernel", "kernel", 260, 8, corr=2),
        _ev("void gemm<float>(float*)", "kernel", 460, 20, corr=3),
        _ev("fill_kernel", "kernel", 710, 2, corr=4),
    ]}
    ops = port_dt.parse_trace(doc, "t", mark)
    assert ops.by_op == {"aten::mm#0": pytest.approx(30e-6),
                         "repro_torch::triad#0": pytest.approx(8e-6),
                         "aten::mm#1": pytest.approx(20e-6)}
    assert ops.total_s == pytest.approx(60e-6)
    assert ops.by_name == {"gemm": pytest.approx(50e-6),
                           "triad_vec_kernel": pytest.approx(8e-6),
                           "fill_kernel": pytest.approx(2e-6)}


def test_op_ranges_in_a_profiled_call_match_count_ops():
    """Under ``OpCounter(mark=True)`` a profiler window over one call holds
    one range per record, named by its key."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models.workloads import build_workload
    w = build_workload("train_step", device="cpu")
    counter = port_ops.OpCounter(mark=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(port_dt.MARK):
            with counter:
                w.fn(*w.args)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "t.json"
        prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
    ranges = sorted(e["name"] for e in doc["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and port_dt._OP_KEY.match(e["name"]))
    assert ranges == sorted(o.name for o in counter.module().ops)
    assert port_dt.parse_trace(doc, "t", port_dt.MARK) is None


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------


def test_cli_attribute_static(tmp_path, capsys):
    from repro_torch import roofline_report
    out_json = tmp_path / "attr.json"
    out_html = tmp_path / "dash.html"
    assert roofline_report.main([
        "--attribute", "dgemm", "--static", "--device", "cpu",
        "--attribution-json", str(out_json), "--html", str(out_html),
        "--max-trial-rows", "5"]) == 0
    err = capsys.readouterr().err
    assert "attributed 1 ops of dgemm (static mode" in err
    assert "h100-sxm theoretical peaks" in err
    doc = json.loads(out_json.read_text())
    assert doc["mode"] == "static" and doc["unattributed_s"] == 0.0
    assert doc["roofs"]["fingerprint"] == "h100-sxm (theoretical)"
    assert all(op["subsystem"] and op["pct_of_roof"] is not None
               for op in doc["ops"])
    assert "Attribution —" in out_html.read_text(encoding="utf-8")


def test_cli_attribute_needs_a_workload_or_a_cache(capsys):
    from repro_torch import roofline_report
    with pytest.raises(SystemExit):
        roofline_report.main([])
    assert roofline_report.main(["--attribute", "nope", "--device",
                                 "cpu"]) == 2


def test_cli_attribute_takes_the_workload_shape(tmp_path, capsys):
    from repro_torch import roofline_report
    flops = {}
    for batch in (1, 2):
        out_json = tmp_path / f"attr{batch}.json"
        assert roofline_report.main([
            "--attribute", "decode_step", "--arch", "granite_3_2b",
            "--batch", str(batch), "--seq-len", "24", "--static",
            "--device", "cpu", "--attribution-json", str(out_json)]) == 0
        doc = json.loads(out_json.read_text())
        assert doc["workload"] == "decode_step"
        flops[batch] = doc["total_flops"]
    # one token per sequence: twice the batch, twice the products
    assert flops[2] == pytest.approx(2 * flops[1], rel=1e-6)


def test_cli_attribute_full_builds_the_full_config(monkeypatch, capsys):
    from repro_torch import configs, roofline_report
    from repro_torch.models import workloads
    seen = {}

    def refuse(name, arch, **kw):
        seen.update(name=name, arch=arch, **kw)
        raise ValueError("not built here")

    monkeypatch.setattr(workloads, "build_workload", refuse)
    assert roofline_report.main([
        "--attribute", "prefill_step", "--arch", "zamba2_2_7b", "--full",
        "--batch", "4", "--seq-len", "4096", "--static", "--device",
        "cpu"]) == 2
    assert seen["arch"] == configs.get("zamba2_2_7b")
    assert (seen["batch_size"], seen["seq_len"]) == (4, 4096)
    with pytest.raises(SystemExit):
        roofline_report.main(["--attribute", "prefill_step", "--full",
                              "--device", "cpu"])


def test_tune_cli_live_and_strict_validate(tmp_path, capsys):
    from repro_torch.tune import main
    assert main(["--session", "s", "--benchmark", "triad", "--device", "cpu",
                 "--cache-dir", str(tmp_path), "--validate", "strict",
                 "--live"]) == 0
    captured = capsys.readouterr()
    live = [ln for ln in captured.err.split("\r") if ln.startswith("[live]")]
    assert live[-1].startswith("[live] trials 3 (pruned 0, cached 0) | "
                               "exec-cache hits ")
    assert "best      : " in captured.out
    assert main(["--session", "s", "--benchmark", "synthetic", "--device",
                 "cpu", "--cache-dir", str(tmp_path), "--validate",
                 "off"]) == 0
