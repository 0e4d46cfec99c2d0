"""decode_ms_per_step.serve (serving launcher and graphs): as
``decode_ms_per_step``, over ``generate``'s batches. It moves
``tokens_per_s``."""

from perfbench.lib import spec

read = spec.metric_reader("decode_ms_per_step").read
