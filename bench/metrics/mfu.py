"""A request's counted operations (``bench/work.py``) over its wall time in the untraced window, as a
share of the card's published float32 peak, in %."""


def read(run):
    if run.peaks is None or not run.requests:
        return None
    return 100.0 * run.work["flops"] / (run.window_s / run.requests) / run.peaks["flops_per_s"]
