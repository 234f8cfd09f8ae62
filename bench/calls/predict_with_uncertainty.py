"""Warm ``GaussianProcess.predict_with_uncertainty``: mean and variance from a cached factor.

Set-up fits one GP on the first dataset of the pool and builds its
posterior; request i then predicts at the whole test set i mod
``test_sets``, each of the configuration's ``n_test`` rows (the paper
predicts at its whole test set in one call).  The factor is never rebuilt:
the work is CROSS, the forward solve of the cross tiles and the covariance
tail.
"""

from __future__ import annotations

from torch.profiler import record_function

from bench import program
from bench import work as yardstick


def prepare(ctx) -> None:
    x, y = ctx.pool[0]
    ctx.state["gp"] = program.make_gp(ctx.cfg, x, y, ctx.device)
    ctx.state["gp"].posterior()


def warmup(ctx) -> None:
    for i in range(ctx.mix["warmup_requests"]):
        request(ctx, -1 - i, next_input(ctx, -1 - i))


def next_input(ctx, i):
    """Request i's test set: the next of the mix's ``test_sets``, made from the seed."""
    return i % len(ctx.tests)


def request(ctx, i, inp):
    with record_function("bench.predict_with_uncertainty"):
        mean, var = ctx.state["gp"].predict_with_uncertainty(ctx.tests[inp])
    return {"dataset": 0, "test": inp, "mean": mean, "var": var}


def units(ctx):
    return {"points": ctx.tests[0].shape[0], "steps": 1}


def work(cfg, mix):
    return yardstick.warm_uncertainty(cfg["n_train"], cfg["n_test"], cfg["n_features"])


def cache_ok(counters, n):
    cold = counters.get("cache.posterior.cold", 0)
    warm = counters.get("cache.posterior.warm", 0)
    return warm == n and cold == 0, f"{warm:g} warm and {cold:g} cold posterior reads in {n} requests"


def release(ctx) -> None:
    ctx.state.pop("gp", None)
