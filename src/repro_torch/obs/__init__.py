"""Observability: span tracing, metrics, Chrome-trace export, device timing.

The subsystem is import-light: no module here imports
``repro_torch.core`` at module level, so core modules may import
:mod:`repro_torch.obs.metrics` at the top of the file without a cycle.
The :class:`TraceRecorder` reaches back into
``repro_torch.core.profiling`` only at install time (``__enter__``) to
wire itself in as the trace sink behind the dual-sink ``phase()``
helpers. Per-op roofline attribution (:mod:`.attribution`) imports the
trial cache's reader only when it recovers roofs.
"""

from .attribution import (AttributedOp, AttributionReport, Roofs, attribute,
                          attribution_from_static, roofs_from_trials)
from .device_timing import (DeviceOps, DeviceTiming, DeviceTimingError,
                            device_timing_available, profile_ops,
                            profile_sample)
from .export import (load_events, to_chrome_trace, trial_summaries,
                     validate_chrome_trace, write_chrome_trace)
from .metrics import MetricsRegistry, metrics
from .trace import TRACE_VERSION, TraceRecorder, recorder

__all__ = [
    "AttributedOp",
    "AttributionReport",
    "DeviceOps",
    "DeviceTiming",
    "DeviceTimingError",
    "MetricsRegistry",
    "Roofs",
    "TRACE_VERSION",
    "TraceRecorder",
    "attribute",
    "attribution_from_static",
    "device_timing_available",
    "load_events",
    "metrics",
    "profile_ops",
    "profile_sample",
    "recorder",
    "roofs_from_trials",
    "to_chrome_trace",
    "trial_summaries",
    "validate_chrome_trace",
    "write_chrome_trace",
]
