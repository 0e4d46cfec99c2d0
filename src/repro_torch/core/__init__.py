"""Core contribution of the paper: CI-pruned autotuning benchmarking.

Public API re-exports; each module mirrors its ``repro.core`` namesake.
"""

from .cache import (AUTO_LEDGER, CACHE_VERSION, BoundCache, CachedTrial,
                    TrialCache, TuningSession, config_key,
                    hardware_fingerprint, iter_trials, load_trials,
                    settings_key)
from .confidence import (Interval, ReservoirBootstrap, ci_mean,
                         median_of_means, normal_quantile,
                         sign_test_median_ci, spearman, t_quantile)
from .evaluator import (BatchCalibration, ClockCalibration, EvalResult,
                        EvaluationSettings, Evaluator, InvocationResult,
                        TimingResolutionWarning, calibrate_batch,
                        calibrate_clock, steady_sampler, timed_sampler)
from .exec_cache import (CompilePipeline, ExecCacheStats, ExecutableCache,
                         TensorSpec, default_cache)
from .executor import (Batch, BatchStats, ExecutionBackend, ExecutionStats,
                       IncumbentCell, ProcessPoolBackend, SerialBackend,
                       SimulatedShardedBackend, ThreadPoolBackend,
                       TrialOutcome)
from .profiling import (PhaseProfiler, PhaseStats, phase, profiler,
                        record_phase, trace_instant, trace_sink, trace_span)
from .report import (FingerprintReport, IncumbentTrial, build_reports,
                     dgemm_config_intensity, extract_incumbent,
                     group_by_fingerprint, pooled_state, render_csv,
                     render_markdown, trials_from_result, triad_subsystems)
from .roofline import (H100_SXM, H100_SXM_BF16_FLOPS, TRIAD_INTENSITY,
                       MachineSpec, RooflineModel, attainable,
                       from_measurements, operational_intensity,
                       ridge_point)
from .searchspace import (Config, Param, SearchSpace, doubling_from, grid,
                          param, powers_of_two)
from .stop_conditions import (CIConverged, Direction, EvalContext, MaxCount,
                              MaxTime, StopCondition, StopDecision,
                              UpperBoundPrune)
from .strategy import (ExhaustiveStrategy, NeighborhoodStrategy,
                       RandomSearchStrategy, SearchStrategy,
                       SuccessiveHalvingStrategy)
from .tuner import (BenchmarkFactory, EvaluateTask, TrialRecord, Tuner,
                    TuningResult, compare_techniques, standard_techniques,
                    tune_successive_halving)
from .welford import (WelfordState, batch_state, from_samples, init, merge,
                      tree_merge, update)

__all__ = [
    "AUTO_LEDGER", "BoundCache", "CACHE_VERSION", "CachedTrial", "TrialCache",
    "TuningSession", "config_key", "hardware_fingerprint", "iter_trials",
    "load_trials", "settings_key",
    "Interval", "ReservoirBootstrap", "ci_mean", "median_of_means",
    "normal_quantile", "sign_test_median_ci", "spearman", "t_quantile",
    "FingerprintReport", "IncumbentTrial", "build_reports",
    "dgemm_config_intensity", "extract_incumbent", "group_by_fingerprint",
    "pooled_state", "render_csv", "render_markdown", "trials_from_result",
    "triad_subsystems",
    "BatchCalibration", "ClockCalibration", "EvalResult",
    "EvaluationSettings", "Evaluator", "InvocationResult",
    "TimingResolutionWarning", "calibrate_batch", "calibrate_clock",
    "steady_sampler", "timed_sampler",
    "CompilePipeline", "ExecCacheStats", "ExecutableCache", "TensorSpec",
    "default_cache",
    "PhaseProfiler", "PhaseStats", "phase", "profiler",
    "record_phase", "trace_instant", "trace_sink", "trace_span",
    "Batch", "BatchStats", "ExecutionBackend", "ExecutionStats",
    "IncumbentCell", "ProcessPoolBackend", "SerialBackend",
    "SimulatedShardedBackend", "ThreadPoolBackend", "TrialOutcome",
    "H100_SXM", "H100_SXM_BF16_FLOPS", "MachineSpec", "RooflineModel",
    "TRIAD_INTENSITY", "attainable", "from_measurements",
    "operational_intensity", "ridge_point",
    "Config", "Param", "SearchSpace", "doubling_from", "grid", "param",
    "powers_of_two",
    "CIConverged", "Direction", "EvalContext", "MaxCount", "MaxTime",
    "StopCondition", "StopDecision", "UpperBoundPrune",
    "ExhaustiveStrategy", "NeighborhoodStrategy", "RandomSearchStrategy",
    "SearchStrategy", "SuccessiveHalvingStrategy",
    "BenchmarkFactory", "EvaluateTask", "TrialRecord", "Tuner",
    "TuningResult", "compare_techniques", "standard_techniques",
    "tune_successive_halving",
    "WelfordState", "batch_state", "from_samples", "init", "merge",
    "tree_merge", "update",
]
