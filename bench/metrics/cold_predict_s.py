"""Seconds a cold prediction: the whole window over the requests completed in it."""


def read(run):
    if not run.requests:
        return None
    return run.window_s / run.requests
