"""The port's round-synchronized backends against the JAX package's:
``shard_configs``, the simulated fleet's trial order, workers, pruning
and exact per-worker time accounting under an injected clock, the
spawn-based process pool, the picklable benchmarks it carries, spawned
workers sharing one cold kernel build, and the CLI's ``--backend
process:N`` session resuming from its cache."""

import multiprocessing
import os
import pathlib
import pickle
import subprocess
import sys
import time

import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.executor import shard_configs as ref_shard_configs
from repro_torch.bench import common
from repro_torch.core.executor import shard_configs

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n_configs,n_workers",
                         [(0, 3), (1, 4), (7, 2), (12, 4), (13, 5), (5, 8)])
def test_shard_configs_equals_the_reference(n_configs, n_workers):
    configs = [{"x": i, "y": i % 3} for i in range(n_configs)]
    assert shard_configs(configs, n_workers) == \
        ref_shard_configs(configs, n_workers)


class FakeClock:
    """Time advances only when a benchmark invocation says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def costed(clock: FakeClock):
    """Deterministic objective whose invocations cost x-dependent time on
    the fake clock (multiples of 1/8 s: exact in binary)."""
    def bench(cfg):
        mu = 100.0 - (cfg["x"] - 7) ** 2

        def factory():
            clock.t += 0.5 + 0.125 * cfg["x"]
            return lambda: mu

        return factory

    return bench


def _simulated(mod, n_workers=4):
    clock = FakeClock()
    settings = mod.EvaluationSettings(max_invocations=3, max_iterations=20,
                                      max_time_s=1e9,
                                      use_ci_convergence=True,
                                      use_inner_prune=True,
                                      use_outer_prune=True)
    tuner = mod.Tuner(mod.grid(x=tuple(range(12))), settings, clock=clock)
    result = tuner.tune(costed(clock), validate="off", pipeline="off",
                        backend=mod.SimulatedShardedBackend(n_workers,
                                                            clock=clock))
    return result


@pytest.mark.parametrize("n_workers", [1, 3, 4])
def test_simulated_backend_matches_the_reference(n_workers):
    ours, theirs = _simulated(port, n_workers), _simulated(ref, n_workers)
    assert [(t.config, t.worker, t.result.pruned, t.result.stop_reason)
            for t in ours.trials] == \
        [(t.config, t.worker, t.result.pruned, t.result.stop_reason)
         for t in theirs.trials]
    assert ours.parallel_time_s == theirs.parallel_time_s
    assert ours.serial_time_s == theirs.serial_time_s
    assert ours.best_config == theirs.best_config == {"x": 7}
    assert ours.backend == "simulated" and ours.n_workers == n_workers
    assert len(ours.batches) == len(theirs.batches)
    assert ours.improvements == theirs.improvements


def test_simulated_accounting_is_the_slowest_worker():
    result = _simulated(port, 4)
    per_worker = {}
    for t in result.trials:
        per_worker[t.worker] = per_worker.get(t.worker, 0.0) + \
            sum(0.5 + 0.125 * t.config["x"]
                for _ in t.result.invocations)
    assert set(per_worker) == {0, 1, 2, 3}
    assert result.parallel_time_s == max(per_worker.values())
    assert result.parallel_time_s < result.serial_time_s


def test_process_backend_finds_the_serial_best():
    space = port.grid(x=tuple(range(12)))
    settings = port.EvaluationSettings(max_invocations=2, max_iterations=10,
                                       use_ci_convergence=True,
                                       use_inner_prune=True,
                                       use_outer_prune=True)
    serial = port.Tuner(space, settings).tune(common.synthetic_benchmark)
    pooled = port.Tuner(space, settings).tune(
        common.synthetic_benchmark, backend=port.ProcessPoolBackend(2))
    assert pooled.best_config == serial.best_config == {"x": 7}
    assert pooled.best_score == serial.best_score
    assert pooled.backend == "process" and pooled.n_workers == 2
    assert [t.config for t in pooled.trials] == list(space.configs())
    assert {t.worker for t in pooled.trials} == {0, 1}


def test_process_backend_rejects_a_closure():
    def closure(cfg):
        return lambda: (lambda: float(cfg["x"]))

    tuner = port.Tuner(port.grid(x=(1, 2)),
                       port.EvaluationSettings(max_invocations=1,
                                               max_iterations=2))
    with pytest.raises(TypeError, match="picklable"):
        tuner.tune(closure, backend=port.ProcessPoolBackend(2))


@pytest.mark.parametrize("make", [common.dgemm_benchmark,
                                  common.triad_benchmark,
                                  common.gemm_tiled_benchmark])
def test_benchmarks_pickle_with_their_device(make):
    bench = make("cpu")
    copy = pickle.loads(pickle.dumps(bench))
    assert type(copy) is type(bench) and copy.device == "cpu"
    assert callable(copy.precompile)
    assert pickle.loads(pickle.dumps(common.dgemm_benchmark(
        "cpu", sampler="steady", reuse_data=True))).reuse_data is True


def test_gemm_tiled_operands_are_not_pickled(monkeypatch):
    monkeypatch.setattr(common, "GEMM_TILED_SHAPE",
                        {"m": 8, "n": 4, "k": 6})
    bench = common.gemm_tiled_benchmark("cpu")
    a, _ = bench.operands()
    assert bench.operands()[0] is a           # drawn once
    copy = pickle.loads(pickle.dumps(bench))
    assert copy._operands is None
    assert (copy.operands()[0] == a).all()


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.tune", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_process_session_resumes_from_its_cache(tmp_path):
    args = ["--session", "pp", "--benchmark", "synthetic", "--device", "cpu",
            "--cache-dir", str(tmp_path), "--backend", "process:2"]
    first = _cli(args, tmp_path)
    assert first.returncode == 0, first.stderr
    assert "backend   : process  workers=2" in first.stdout
    assert "trials    : 12  cached=0" in first.stdout
    again = _cli(args, tmp_path)
    assert again.returncode == 0, again.stderr
    assert "cached     : 12 trials" in again.stdout
    assert "trials    : 12  cached=12" in again.stdout
    assert "best      : {'x': 7}" in again.stdout


def test_cli_simulated_session_with_trace(tmp_path):
    first = _cli(["--session", "sim", "--benchmark", "synthetic",
                  "--device", "cpu", "--cache-dir", str(tmp_path),
                  "--backend", "simulated:4", "--trace"], tmp_path)
    assert first.returncode == 0, first.stderr
    assert "backend   : simulated  workers=4" in first.stdout
    trace = tmp_path / "sim.trace.jsonl"
    assert f"trace     : {trace}" in first.stdout
    from repro_torch.obs import load_events, trial_summaries
    assert len(trial_summaries(load_events(trace))) == 12
    bad = _cli(["--session", "x", "--benchmark", "synthetic", "--device",
                "cpu", "--backend", "mpi:2"], tmp_path)
    assert bad.returncode != 0 and "simulated[:N]" in bad.stderr


def _cold_build(root: str, barrier, results) -> None:
    """A spawned worker reaching the kernel library's first use: the
    compiler is replaced by a slow stand-in that logs each build."""
    from repro_torch.kernels import build

    def slow_build(so: pathlib.Path) -> None:
        time.sleep(1.0)
        with open(pathlib.Path(root) / "builds.log", "a") as fh:
            fh.write(f"{os.getpid()}\n")
        so.write_bytes(b"")

    build.BUILD_ROOT = pathlib.Path(root)
    build._build = slow_build
    build.ctypes.CDLL = str          # "load" = the library's path
    barrier.wait(timeout=60)
    results.put(build.library())


def test_spawned_workers_build_the_kernel_library_once(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    barrier, results = ctx.Barrier(2), ctx.Queue()
    workers = [ctx.Process(target=_cold_build,
                           args=(str(tmp_path), barrier, results))
               for _ in range(2)]
    for w in workers:
        w.start()
    loaded = [results.get(timeout=120) for _ in workers]
    for w in workers:
        w.join(timeout=60)
        assert not w.is_alive() and w.exitcode == 0
    assert len(set(loaded)) == 1 and loaded[0].startswith(str(tmp_path))
    assert len((tmp_path / "builds.log").read_text().split()) == 1
