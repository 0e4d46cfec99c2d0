"""The port's measurement-soundness linter (``repro_torch.lint``) against
the JAX package's (``repro.lint``): the harness pass's codes on the JAX
fixtures translated to torch's idioms (same code, same line), the lock
pass and the finding plumbing through both packages, the CLI's JSON
contract, the workload audit (MS101-103, the audit registry, the traced
work beside the reference's) and the Tuner's pre-run audit hook."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import repro.lint as ref_lint
import repro_torch.lint as port_lint
from repro_torch.lint import (WorkloadAuditError, WorkloadAuditWarning,
                              WorkloadSpec, audit_workload)
from repro_torch.lint.__main__ import main as lint_main

REPO = pathlib.Path(__file__).resolve().parent.parent


def codes(findings):
    return sorted(f.code for f in findings)


def spots(findings):
    return sorted((f.code, f.line) for f in findings)


def run_lint(source):
    return port_lint.lint_source(textwrap.dedent(source), path="fixture.py")


# ---------------------------------------------------------------------------
# Pass 2 — harness timing pitfalls (MS2xx): JAX fixture -> torch idiom
# ---------------------------------------------------------------------------

#: (name, the JAX package's fixture, its torch translation), line for line
PAIRS = [
    ("ms201", """
        import time
        import jax.numpy as jnp

        def bench(a, b):
            t0 = time.perf_counter()
            c = jnp.dot(a, b)
            return time.perf_counter() - t0
    """, """
        import time
        import torch

        def bench(a, b):
            t0 = time.perf_counter()
            c = torch.matmul(a, b)
            return time.perf_counter() - t0
    """),
    ("ms202", """
        import time
        import jax

        def bench(f, x):
            t0 = time.time()
            jax.block_until_ready(f(x))
            return time.time() - t0
    """, """
        import time
        import torch

        def bench(f, x):
            t0 = time.time()
            f(x).cpu()
            return time.time() - t0
    """),
    ("ms203", """
        import time
        import jax

        def bench(g, xs):
            t0 = time.perf_counter()
            for x in xs:
                f = jax.jit(g)
                jax.block_until_ready(f(x))
            return time.perf_counter() - t0
    """, """
        import time
        import torch

        def bench(g, xs):
            t0 = time.perf_counter()
            for x in xs:
                f = torch.compile(g)
                f(x).cpu()
            return time.perf_counter() - t0
    """),
    ("ms204", """
        import time
        import jax

        def bench(g, x):
            f = jax.jit(g)
            t0 = time.perf_counter()
            f(x)
            jax.block_until_ready(x)
            return time.perf_counter() - t0
    """, """
        import time
        import torch

        def bench(g, x):
            f = torch.compile(g)
            t0 = time.perf_counter()
            f(x)
            x.cpu()
            return time.perf_counter() - t0
    """),
    ("ms205", """
        import numpy as np
        import random

        def data(n):
            return np.random.rand(n), random.random()
    """, """
        import torch
        import random

        def data(n):
            return torch.rand(n), random.random()
    """),
    ("ms205_seeded", """
        import numpy as np
        import random

        def data(n, seed):
            rng = np.random.default_rng(seed)
            r = random.Random(seed)
            return rng.normal(size=n), r.random()
    """, """
        import torch
        import random

        def data(n, seed):
            gen = torch.Generator().manual_seed(seed)
            r = random.Random(seed)
            return torch.randn(n, generator=gen), r.random()
    """),
    ("ms206", """
        import time
        import jax

        def bench(g, params, batch):
            f = jax.jit(g)
            t0 = time.perf_counter()
            logits, cache = f(params, batch)
            jax.block_until_ready(logits)
            dt = time.perf_counter() - t0
            return dt, cache
    """, """
        import time
        import torch

        def bench(g, params, batch):
            f = torch.compile(g)
            t0 = time.perf_counter()
            logits, cache = f(params, batch)
            logits.cpu()
            dt = time.perf_counter() - t0
            return dt, cache
    """),
    ("ms207_factory", """
        import jax
        from repro.core import timed_sampler

        def make(kernel, x):
            def factory():
                f = jax.jit(kernel)
                jax.block_until_ready(f(x))
                return timed_sampler(lambda: jax.block_until_ready(f(x)),
                                     work=1.0)
            return factory
    """, """
        import torch
        from repro_torch.core import timed_sampler

        def make(kernel, x):
            def factory():
                f = torch.compile(kernel)
                f(x).cpu()
                return timed_sampler(lambda: f(x).cpu(),
                                     work=1.0)
            return factory
    """),
    ("ms207_make_invocation", """
        import jax

        def make_invocation():
            return jax.jit(kernel)
    """, """
        import torch

        def make_invocation():
            return torch.compile(kernel)
    """),
    ("ms207_cached_factory", """
        import jax
        from repro.core import default_cache, steady_sampler

        def make(kernel, x):
            def factory():
                f = default_cache().compile(kernel, (x,))
                jax.block_until_ready(f(x))
                return steady_sampler(lambda: f(x), work=1.0,
                                      sync=jax.block_until_ready)
            return factory
    """, """
        import torch
        from repro_torch.core import default_cache, steady_sampler

        def make(kernel, x):
            def factory():
                f = default_cache().compile(kernel, (x,))
                f(x).cpu()
                return steady_sampler(lambda: f(x), work=1.0,
                                      sync=torch.cuda.synchronize)
            return factory
    """),
    ("ms207_non_factory", """
        import jax

        def compile_kernel(fn):
            return jax.jit(fn)
    """, """
        import torch

        def compile_kernel(fn):
            return torch.compile(fn)
    """),
    ("clean", """
        import time
        import jax

        def bench(g, x):
            f = jax.jit(g)
            jax.block_until_ready(f(x))   # pre-heat
            t0 = time.perf_counter()
            jax.block_until_ready(f(x))
            return time.perf_counter() - t0
    """, """
        import time
        import torch

        def bench(g, x):
            f = torch.compile(g)
            f(x).cpu()                    # pre-heat
            t0 = time.perf_counter()
            f(x).cpu()
            return time.perf_counter() - t0
    """),
    ("t0_reassignment", """
        import time
        import jax.numpy as jnp
        import jax

        def bench(a, b):
            t0 = time.perf_counter()
            c = jnp.dot(a, b)
            dt1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            jax.block_until_ready(jnp.dot(a, b))
            dt2 = time.perf_counter() - t0
            return dt1, dt2
    """, """
        import time
        import torch
        import torch

        def bench(a, b):
            t0 = time.perf_counter()
            c = torch.matmul(a, b)
            dt1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            torch.matmul(a, b).cpu()
            dt2 = time.perf_counter() - t0
            return dt1, dt2
    """),
]

#: the codes the JAX package's tests (tests/test_lint.py) want of each
WANT = {"ms201": ["MS201"], "ms202": ["MS202", "MS202"], "ms203": ["MS203"],
        "ms204": ["MS204"], "ms205": ["MS205", "MS205"], "ms205_seeded": [],
        "ms206": ["MS206"], "ms207_factory": ["MS207"],
        "ms207_make_invocation": ["MS207"], "ms207_cached_factory": [],
        "ms207_non_factory": [], "clean": [], "t0_reassignment": ["MS201"]}


@pytest.mark.parametrize("name,jax_src,torch_src", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_harness_fixture_fires_the_same_code_at_the_same_line(
        name, jax_src, torch_src):
    ref = ref_lint.lint_source(textwrap.dedent(jax_src), path="fixture.py")
    ours = run_lint(torch_src)
    assert spots(ours) == spots(ref)
    assert [c for c in codes(ours) if c.startswith("MS2")] == \
        sorted(WANT[name])


@pytest.mark.parametrize("source,want", [
    # a port kernel wrapper is device work (absolute and relative imports)
    ("""
        import time
        from repro_torch.kernels import triad

        def bench(a, b):
            t0 = time.perf_counter()
            c = triad(a, b)
            return time.perf_counter() - t0
    """, [("MS201", 8)]),
    ("""
        import time
        from ..kernels.ssd import chunk_scan

        def bench(*ops):
            t0 = time.perf_counter()
            y = chunk_scan(*ops)
            return time.perf_counter() - t0
    """, [("MS201", 8)]),
    # the port's synchronizer and a card clock's sample are syncs
    ("""
        import time
        import torch
        from repro_torch.device import synchronizer

        def bench(a, b, dev):
            sync = synchronizer(dev)
            t0 = time.perf_counter()
            c = torch.matmul(a, b)
            sync()
            return time.perf_counter() - t0
    """, []),
    ("""
        import time
        import torch
        from repro_torch.core.card_clock import CardClock

        def bench(a, b):
            card = CardClock()
            t0 = time.perf_counter()
            dt = card.measure(lambda: torch.matmul(a, b))
            return time.perf_counter() - t0, dt
    """, []),
    # a stream-wide synchronize covers a discarded result; a tensor sync
    # of another tensor does not
    ("""
        import time
        import torch

        def bench(a, b):
            t0 = time.perf_counter()
            torch.matmul(a, b)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
    """, []),
    ("""
        import time
        import torch

        def bench(a, b):
            t0 = time.perf_counter()
            torch.matmul(a, b)
            b.item()
            return time.perf_counter() - t0
    """, [("MS204", 7)]),
    # a kernel build inside a timed loop, and inside a factory
    ("""
        import time
        from repro_torch.kernels import build

        def bench(xs):
            t0 = time.perf_counter()
            for x in xs:
                fn = build.kernel_fn("rt_triad_f32", ())
            return time.perf_counter() - t0
    """, [("MS203", 8)]),
    ("""
        from repro_torch.kernels import build

        def factory():
            return build.library()
    """, [("MS207", 5)]),
    # torch utilities are no device work
    ("""
        import time
        import torch

        def bench():
            t0 = time.perf_counter()
            dev = torch.device("cuda")
            n = torch.cuda.device_count()
            return time.perf_counter() - t0
    """, []),
    # every sampling function without generator=
    ("""
        import torch

        def data(x):
            return (torch.randn(3), torch.randint(0, 5, (3,)),
                    torch.randperm(4), torch.normal(0.0, 1.0, (2,)),
                    torch.rand_like(x))
    """, [("MS205", 5), ("MS205", 5), ("MS205", 6), ("MS205", 6),
          ("MS205", 7)]),
])
def test_torch_idioms(source, want):
    assert spots(run_lint(source)) == want


# ---------------------------------------------------------------------------
# Suppression (the JAX fixtures, through both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lint", [ref_lint, port_lint], ids=["ref", "port"])
@pytest.mark.parametrize("marker,code,kept", [
    ("# lint: ok=MS205", "MS205", False),
    ("# lint: ok", "MS205", False),
    ("# lint: ok=MS999", "MS205", True),
])
def test_suppression(tmp_path, lint, marker, code, kept):
    fixture = tmp_path / "fixture.py"
    fixture.write_text(textwrap.dedent(f"""
        import numpy as np

        def data(n):
            return np.random.rand(n)   {marker}
    """))
    findings = lint.lint_file(fixture)
    assert code in codes(findings)
    assert (code in codes(lint.filter_suppressed(findings))) == kept


@pytest.mark.parametrize("lint", [ref_lint, port_lint], ids=["ref", "port"])
def test_suppression_of_named_code_on_its_line(tmp_path, lint):
    fixture = tmp_path / "fixture.py"
    fixture.write_text(textwrap.dedent("""
        import time

        def bench(f, x):
            t0 = time.time()   # lint: ok=MS202
            f(x)
            return time.perf_counter() - t0
    """))
    findings = lint.lint_file(fixture)
    assert "MS202" in codes(findings)
    assert "MS202" not in codes(lint.filter_suppressed(findings))


def test_serve_prefill_sync_regression():
    """The port's counterpart of ``tests/test_lint.py::
    test_serve_prefill_sync_regression``: the serving launcher synchronizes
    the device before each clock read, after the prefill (MS206) and
    after the decode loop (MS201)."""
    serve_py = REPO / "src" / "repro_torch" / "launch" / "serve.py"
    findings = port_lint.lint_file(serve_py)
    assert port_lint.filter_suppressed(findings) == []


# ---------------------------------------------------------------------------
# Pass 3 — lock discipline (MS3xx)
# ---------------------------------------------------------------------------

LOCK_FIXTURES = {
    "unlocked_append": """
        class Store:
            def put(self, line):
                with open(self.path, "a") as f:
                    f.write(line)
    """,
    "truncating_rewrite": """
        import fcntl

        class Store:
            def _flocked(self):
                f = open(self.path, "a")
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                return f

            def rewrite(self, lines):
                with self._flocked():
                    with open(self.path, "w") as f:
                        f.writelines(lines)
    """,
    "locked_append": """
        import fcntl

        class Store:
            def _flocked(self):
                f = open(self.path, "a")
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                return f

            def put(self, line):
                with self._flocked() as f:
                    f.write(line)
    """,
    "replace_without_inode_check_or_fsync": """
        import fcntl
        import os

        class Store:
            def _flocked(self):
                f = open(self.path, "a")
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                return f

            def compact(self, lines):
                with self._flocked():
                    tmp = self.path.with_name("tmp")
                    with open(tmp, "w") as f:
                        f.writelines(lines)
                    os.replace(tmp, self.path)
    """,
}


@pytest.mark.parametrize("name", sorted(LOCK_FIXTURES))
def test_lock_findings_identical_through_both_packages(name):
    src = textwrap.dedent(LOCK_FIXTURES[name])
    ours = port_lint.check_lock_source(src, path="store.py")
    ref = ref_lint.check_lock_source(src, path="store.py")
    assert [f.to_json() for f in ours] == [f.to_json() for f in ref]
    if name != "locked_append":
        assert ours


def test_port_lock_targets_exist_and_are_clean():
    assert all((REPO / t).is_file() for t in port_lint.DEFAULT_LOCK_TARGETS)
    assert all(t.startswith("src/repro_torch/")
               for t in port_lint.DEFAULT_LOCK_TARGETS)
    findings = port_lint.check_lock_discipline(root=REPO)
    assert findings == [], [f.render() for f in findings]


# ---------------------------------------------------------------------------
# Finding plumbing
# ---------------------------------------------------------------------------

def test_codes_and_version_are_the_reference_s():
    assert port_lint.CODES == ref_lint.CODES
    assert port_lint.LINT_VERSION == ref_lint.LINT_VERSION


def test_worst_severity_and_json_document():
    assert port_lint.worst_severity([]) is None
    findings = run_lint("""
        import torch

        def data(n):
            return torch.randn(n)
    """)
    assert port_lint.worst_severity(findings) == "warning"
    ours = port_lint.findings_to_json(findings)
    ref = ref_lint.findings_to_json(
        [ref_lint.make_finding(f.code, f.path, f.line, f.message)
         for f in findings])
    assert ours == ref


# ---------------------------------------------------------------------------
# CLI contract (python -m repro_torch.lint)
# ---------------------------------------------------------------------------

BROKEN_FIXTURE = textwrap.dedent("""
    import time
    import torch

    def bench(a, b):
        x = torch.rand(4)
        t0 = time.time()
        c = torch.matmul(a, b)
        return time.time() - t0
""")


def test_cli_json_reports_exact_codes(tmp_path, capsys):
    fixture = tmp_path / "broken.py"
    fixture.write_text(BROKEN_FIXTURE)
    assert lint_main(["--no-trace", "--json", str(fixture)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["lint_version"] == port_lint.LINT_VERSION
    # both time.time() calls (opening and closing the region) fire MS202
    assert sorted(f["code"] for f in doc["findings"]) == \
        ["MS201", "MS202", "MS202", "MS205"]
    assert doc["summary"] == {"error": 0, "warning": 4, "info": 0}
    for f in doc["findings"]:
        assert set(f) >= {"code", "path", "line", "message", "severity",
                          "pass"}


def test_cli_clean_fixture_exits_zero(tmp_path, capsys):
    fixture = tmp_path / "clean.py"
    fixture.write_text("x = 1\n")
    assert lint_main(["--no-trace", "--json", str(fixture)]) == 0
    assert json.loads(capsys.readouterr().out)["findings"] == []


def test_cli_missing_path_is_usage_error(tmp_path):
    assert lint_main(["--no-trace", str(tmp_path / "nope")]) == 2


def test_cli_port_tree_is_clean_with_the_audit_on_the_host(capsys):
    """The port's own tree (``src/repro_torch``, ``chip_smoke.py``, the
    port's tests) lints clean, pass 1 included."""
    rc = lint_main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.rstrip().endswith("0 error(s), 0 warning(s), 1 info")


def test_cli_without_a_card_refuses_pass_one(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lint_main([str(REPO / "chip_smoke.py")]) == 2
    assert "is_available" in capsys.readouterr().err


def test_cli_runs_with_jax_and_the_reference_blocked(tmp_path):
    from test_torch_guards import BLOCKER
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER + """
from repro_torch.lint.__main__ import main
rc = main(["--device", "cpu", "--json"])
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
raise SystemExit(rc)
"""], env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=tmp_path,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["summary"]["warning"] == 0


# ---------------------------------------------------------------------------
# Pass 1 — workload audit
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_ms101_wrong_declared_work():
    spec = WorkloadSpec(fn=torch.matmul, args=(_meta(8, 8), _meta(8, 8)),
                        work=8.0 * 8 * 8,     # forgot the factor of 2
                        unit="flops", dtype="float32", name="bad-dgemm")
    assert "MS101" in codes(audit_workload(spec))


def test_ms102_dead_kernel():
    def dead(x):
        return torch.zeros((), device=x.device)

    spec = WorkloadSpec(fn=dead, args=(_meta(128),), work=128.0,
                        unit="flops", dtype="float32", name="dead")
    assert "MS102" in codes(audit_workload(spec))


def test_ms102_nothing_dispatched():
    spec = WorkloadSpec(fn=lambda x: x, args=(_meta(128),), work=128.0,
                        unit="bytes", name="identity")
    found = audit_workload(spec)
    assert codes(found) == ["MS102"]
    assert "ops dispatched=0" in found[0].message


def test_ms103_dtype_mismatch():
    spec = WorkloadSpec(fn=torch.matmul, args=(_meta(8, 8), _meta(8, 8)),
                        work=2.0 * 8 * 8 * 8, unit="flops", dtype="float64",
                        name="not-actually-f64")
    found = audit_workload(spec)
    assert codes(found) == ["MS103"]
    assert "operand dtypes" in found[0].message


def test_ms104_trace_failure_is_reported_not_raised():
    spec = WorkloadSpec(fn=torch.matmul, args=(_meta(8, 3), _meta(4, 8)),
                        work=1.0, unit="flops", name="broken")
    assert codes(audit_workload(spec)) == ["MS104"]


def test_correct_declaration_is_clean():
    spec = WorkloadSpec(fn=torch.matmul, args=(_meta(16, 4), _meta(4, 8)),
                        work=2.0 * 16 * 8 * 4, unit="flops",
                        dtype="float32", name="good-dgemm")
    assert audit_workload(spec) == []


def test_registered_benchmarks_audit_clean_on_meta():
    from repro_torch.bench.common import AUDITED_WORKLOADS
    assert sorted(AUDITED_WORKLOADS) == ["decode_step", "dgemm",
                                         "dgemm_sweep", "synthetic",
                                         "train_step", "triad"]
    findings = []
    for name, (bench, cfg) in AUDITED_WORKLOADS.items():
        spec = getattr(bench, "audit_spec", None)
        if spec is not None:
            assert all(t.device.type == "meta" for t in spec(cfg).args[:2]
                       if isinstance(t, torch.Tensor))
        findings += [f for f in port_lint.audit_benchmark(bench, cfg,
                                                          name=name)
                     if f.severity != "info"]
    assert findings == [], [f.render() for f in findings]


def test_triad_spec_traces_the_hand_kernel_op():
    from repro_torch.bench.common import triad_audit_spec, triad_moved_bytes
    spec = triad_audit_spec({"n_bytes": 1 << 20})
    traced = port_lint.trace_cost(spec.fn, spec.args)
    n = spec.args[0].numel()
    assert traced.n_eqns == 1
    assert traced.bytes_accessed == 3 * n * 4 == triad_moved_bytes(1 << 20)
    assert traced.out_dtypes == ("float32",)


@pytest.mark.parametrize("name", ["dgemm", "triad", "dgemm_sweep"])
def test_traced_work_matches_the_reference_s(name):
    """The port's traced work of a registered benchmark lies within the
    spec's 5% of the JAX package's traced work on the same config."""
    from benchmarks.common import AUDITED_WORKLOADS as REF
    from repro_torch.bench.common import AUDITED_WORKLOADS as PORT
    bench, cfg = PORT[name]
    ref_bench, ref_cfg = REF[name]
    assert cfg == ref_cfg
    ours, ref = bench.audit_spec(cfg), ref_bench.audit_spec(cfg)
    assert (ours.work, ours.unit, ours.dtype, ours.name) == \
        (ref.work, ref.unit, ref.dtype, ref.name)
    got = port_lint.trace_cost(ours.fn, ours.args).work(ours.unit)
    want = ref_lint.trace_cost(ref.fn, ref.args).work(ref.unit)
    assert got == pytest.approx(want, rel=ours.tolerance)


def test_model_family_spec_counts_the_flash_op_at_use_flash_one():
    """At ``use_flash=0`` the trace is the work term exactly. At
    ``use_flash=1`` the forward's masked S x S products become the flash
    op's causal count (half of them), and the backward still recomputes
    them through the plain attention: the trace exceeds the work term by
    one flash forward a layer (ROADMAP: a difference by design)."""
    from repro_torch.bench.common import model_step_family
    from repro_torch.kernels.flash_attention import flops as flash_flops
    from repro_torch.models.workloads import TINY_CONFIG as cfg
    bench = model_step_family("train_step", device="cpu")
    plain = bench.audit_spec({"use_flash": 0})
    traced = port_lint.trace_cost(plain.fn, plain.args)
    assert traced.flops == plain.work
    flash = bench.audit_spec({"use_flash": 1, "flash_block_q": 64,
                              "flash_block_k": 64})
    assert flash.work == plain.work
    per_layer = flash_flops(2, cfg.n_heads, 64, cfg.head_dim_, True)
    assert port_lint.trace_cost(flash.fn, flash.args).flops == \
        plain.work + cfg.n_layers * per_layer


# ---------------------------------------------------------------------------
# Tuner pre-run audit hook
# ---------------------------------------------------------------------------

def _mis_declared_benchmark(calls):
    def bench(cfg):
        def factory():
            calls.append(cfg)
            return lambda: 1.0
        return factory

    def spec(cfg):
        n = cfg["x"] + 8
        return WorkloadSpec(fn=torch.matmul, args=(_meta(n, n), _meta(n, n)),
                            work=float(n),          # wildly under-declared
                            unit="flops", dtype="float32", name=f"mis[{n}]")

    bench.audit_spec = spec
    return bench


@pytest.fixture
def tuning_bits():
    from repro_torch.core import EvaluationSettings, Tuner, grid
    settings = EvaluationSettings(max_invocations=1, max_iterations=1,
                                  max_time_s=5.0)
    return Tuner(grid(x=(0, 1)), settings)


def test_tuner_strict_raises_before_any_trial(tuning_bits):
    calls = []
    with pytest.raises(WorkloadAuditError) as exc:
        tuning_bits.tune(_mis_declared_benchmark(calls), validate="strict")
    assert calls == []
    assert "MS101" in codes(exc.value.findings)


def test_tuner_warn_default_warns_and_proceeds(tuning_bits):
    calls = []
    with pytest.warns(WorkloadAuditWarning, match="MS101"):
        result = tuning_bits.tune(_mis_declared_benchmark(calls))
    assert calls
    assert result.best_config is not None


def test_tuner_validate_off_is_silent(tuning_bits, recwarn):
    calls = []
    tuning_bits.tune(_mis_declared_benchmark(calls), validate="off")
    assert calls
    assert [w for w in recwarn.list
            if issubclass(w.category, WorkloadAuditWarning)] == []


def test_tuner_rejects_unknown_validate_mode(tuning_bits):
    with pytest.raises(ValueError, match="validate"):
        tuning_bits.tune(lambda cfg: lambda: (lambda: 1.0),
                         validate="sometimes")


def test_tuner_warn_mode_survives_broken_audit_spec(tuning_bits):
    def bench(cfg):
        def factory():
            return lambda: 1.0
        return factory

    bench.audit_spec = "not callable"
    with pytest.warns(WorkloadAuditWarning, match="MS104"):
        result = tuning_bits.tune(bench)
    assert result.best_config is not None


def test_defaults_are_warn_as_in_the_reference():
    import inspect

    import repro.core as ref_core
    import repro_torch.core as port_core
    from repro_torch.sweep import SweepCampaign
    for port_fn, ref_fn in (
            (port_core.Tuner.tune, ref_core.Tuner.tune),
            (port_core.TuningSession.run, ref_core.TuningSession.run)):
        assert inspect.signature(port_fn).parameters["validate"].default \
            == inspect.signature(ref_fn).parameters["validate"].default \
            == "warn"
    assert inspect.signature(SweepCampaign).parameters[
        "validate"].default == "warn"
