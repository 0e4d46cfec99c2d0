"""idle_share.tune (device): the share of the traced window in which no
operation ran on the device, in percent, in a tile search; the card
clock's holds, which wait for the host to queue a sample, count as idle
(``perfbench/lib/trace.py``). It moves ``search_s``."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
