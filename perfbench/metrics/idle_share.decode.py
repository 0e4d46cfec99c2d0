"""idle_share.decode (device): as ``idle_share.serve``, over decode
rounds. It moves ``decode_tokens_per_s``."""

from perfbench.lib import spec

read = spec.metric_reader("idle_share.serve").read
