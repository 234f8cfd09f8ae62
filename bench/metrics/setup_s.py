"""Seconds from the start of the run to the start of the measured window: imports, CUDA, the port's
libraries (built on the first run in a checkout), the data and the warm-up requests."""


def read(run):
    return run.setup_s
