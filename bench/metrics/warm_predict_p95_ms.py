"""The 95th percentile of every request's latency in the window, by nearest rank, in ms."""

import math


def read(run):
    if not run.latencies:
        return None
    ordered = sorted(run.latencies)
    return 1e3 * ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
