"""Distribution layer: mesh-aware sharding rules, the activation-sharding
context, the planned sharded einsum and the distributed tuner (the JAX
package's ``distributed``)."""

from .sharding import (SERVE_RULES, TRAIN_RULES, NamedSharding,
                       ShardingRules, logical_to_spec, placements,
                       spec_tree)
from .tuner import DistributedTuner, replicated_evaluate

__all__ = ["DistributedTuner", "NamedSharding", "SERVE_RULES",
           "TRAIN_RULES", "ShardingRules", "logical_to_spec", "placements",
           "replicated_evaluate", "spec_tree"]
