"""Observability: the process-global metrics registry.

Span tracing, trace export and on-device timing are not ported yet.
"""

from .metrics import MetricsRegistry, metrics

__all__ = ["MetricsRegistry", "metrics"]
