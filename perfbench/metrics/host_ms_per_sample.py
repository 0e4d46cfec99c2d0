"""host_ms_per_sample (evaluator layer: ``core/evaluator.py``,
``core/card_clock.py``): the milliseconds of a session that no sample
measured, per sample: the session's wall time less its samples' own
seconds (each sample's work over its rate, on the card's clock), over
its samples, pooled over the window's sessions. The arithmetic is
``bench/harness.py``'s non-measured time (wall less the samplers'
windows), per sample. It moves ``search_s``."""


def read(run):
    sessions = run.records.get("sessions")
    if not sessions:
        return None
    samples = sum(s["samples"] for s in sessions)
    if samples == 0:
        return None
    idle = sum(s["wall_s"] - s["sample_s"] for s in sessions)
    return idle / samples * 1e3
