"""samples_per_session (search layer: ``core/tuner.py``, ``strategy.py``,
``stop_conditions.py``): the samples a tuning session took, the
``TuningResult.total_samples`` of each session of the window, averaged.
Fewer samples at the same winner is what the paper's stop conditions
buy, and it moves ``search_s``."""


def read(run):
    sessions = run.records.get("sessions")
    if not sessions:
        return None
    return sum(s["samples"] for s in sessions) / len(sessions)
