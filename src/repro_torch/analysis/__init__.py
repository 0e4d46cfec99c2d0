"""Per-op cost of one eager call: the port's counterpart of the JAX
package's HLO cost parser (:mod:`.ops`)."""

from .ops import ModuleOps, OpCost, count_ops

__all__ = ["ModuleOps", "OpCost", "count_ops"]
