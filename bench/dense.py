"""The dense float32 pipeline that the paper compares with (cuSOLVER): the covariance, one
``torch.linalg.cholesky``, ``cholesky_solve``, the cross covariance and the mean, TF32 off, timed on
the host clock around calls ending in a synchronize."""

from __future__ import annotations

import time

import torch

from bench.reference import gp


def predict(x, y, xt, p):
    chol = torch.linalg.cholesky(gp.train_cov(x, p, p["vertical"] + p["noise"]))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    return gp.se(xt, x, p) @ alpha


def seconds_a_request(ctx, requests: int) -> float:
    """Seconds a cold dense prediction over ``requests`` calls on the pool in turn, after one untimed call."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        def call(i):
            x, y = ctx.pool[i % len(ctx.pool)]
            return predict(x, y, ctx.tests[0], ctx.cfg["params"])

        call(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(requests):
            call(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / requests
    finally:
        matmul.allow_tf32 = before
