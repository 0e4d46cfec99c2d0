"""prefill_ms (serving launcher ``launch/serve.py`` ``generate``): the
mean of the window's batches' ``prefill_s``, read by ``generate`` on the
host clock after a device synchronize, in milliseconds. It moves
``tokens_per_s``."""


def read(run):
    batches = run.records.get("batches")
    if not batches:
        return None
    return sum(b["prefill_s"] for b in batches) / len(batches) * 1e3
