"""mfu.decode (model step): as ``mfu.serve``, over decode rounds. It
moves ``decode_tokens_per_s``."""

from perfbench.lib import spec

read = spec.metric_reader("mfu.serve").read
