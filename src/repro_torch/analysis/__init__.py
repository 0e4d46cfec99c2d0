"""Cost analysis: per-op FLOPs and bytes of one eager call (``ops``), the
per-device trace of a sharded step (``trace``) and its roofline terms
(``terms``)."""

from .ops import ModuleOps, OpCost, OpCounter, count_ops, op_key, scope
from .terms import RooflineTerms, analyze, model_flops
from .trace import CollectiveStats, DeviceCounter, StepTrace, trace_call

__all__ = ["CollectiveStats", "DeviceCounter", "ModuleOps", "OpCost",
           "OpCounter", "RooflineTerms", "StepTrace", "analyze",
           "count_ops", "model_flops", "op_key", "scope", "trace_call"]
