"""The dense float32 pipeline's time a cold request over the port's (``cold_predict_s``).

The dense pipeline is ``bench/dense.py`` (``torch.linalg.cholesky``, ``cholesky_solve``, the cross
covariance and the mean, TF32 off), timed in the same process, outside the profiler, on the same
pool; it has a reading only for an exact cold prediction on the card.
"""

from bench import dense


def read(run):
    if run.mix["call"] != "predict" or run.cfg["method"] != "exact" or not run.requests:
        return None
    if run.device.type != "cuda":
        return None
    dense_s = dense.seconds_a_request(run.ctx, requests=run.mix["trace_requests"])
    return dense_s / (run.window_s / run.requests)
