"""Share of the least time of a request's work at the card's published peaks (``bench/work.py``)
in the device's busy time a request, over the traced window, in %."""

from bench import work


def read(run):
    if run.trace is None or run.peaks is None or not run.trace["busy_s"]:
        return None
    busy = run.trace["busy_s"] / run.trace["requests"]
    return 100.0 * work.least_seconds(run.work, run.peaks) / busy
