"""mfu.serve (model step: ``models/transformer.py``, ``layers.py``): the
model FLOPs the window's work needs over the window's span, against 989
TFLOP/s (bf16), in percent. The FLOPs (``perfbench/lib/counts.py``): 2
x the matmul weights a token passes, the causal attention products
(half the square, inside the window) and the output head where logits
are taken. It moves ``tokens_per_s``
(``mfu.decode``, the same over decode rounds: ``decode_tokens_per_s``)."""

from perfbench.lib import peaks, spec


def read(run):
    units = run.records.get("batches") or run.records.get("rounds")
    if not units or run.window_s <= 0:
        return None
    work = spec.kind(run.cell.traffic["kind"]).work(run)
    return 100.0 * len(units) * work["flops"] / run.window_s \
        / peaks.BF16_FLOPS
