"""Seconds an Adam step: the whole window over every step of the requests completed in it."""


def read(run):
    steps = run.requests * run.units["steps"]
    return run.window_s / steps if steps else None
