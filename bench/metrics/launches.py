"""Device kernels a request in the traced window, the port's and the libraries' counted alike."""


def read(run):
    if run.trace is None or not run.trace["requests"]:
        return None
    return run.trace["kernels"] / run.trace["requests"]
