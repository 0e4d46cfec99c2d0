"""decode_ms_per_step (serving launcher and graphs: ``serve.py``
``greedy_decode``, ``graphs.py``): the decode loop's seconds over its
steps, in milliseconds, the eager first step and the capture included:
a decode round's span (the harness's host clock around
``greedy_decode`` and a synchronize) over its steps, or ``generate``'s
``decode_s`` over its gen - 1 steps. It moves ``decode_tokens_per_s``
(``decode_ms_per_step.serve``, the same in ``generate``'s batches:
``tokens_per_s``)."""

from perfbench.lib import spec


def read(run):
    work = spec.kind(run.cell.traffic["kind"]).work(run)
    if run.records.get("batches"):
        seconds = sum(b["decode_s"] for b in run.records["batches"])
        steps = work["steps"] * len(run.records["batches"])
    elif run.records.get("rounds"):
        seconds = sum(r["seconds"] for r in run.records["rounds"])
        steps = work["steps"] * len(run.records["rounds"])
    else:
        return None
    return seconds / steps * 1e3 if steps else None
