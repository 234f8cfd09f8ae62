"""Cold ``GaussianProcess.predict``: a new GP on the next dataset of the pool, then the mean at the test rows.

Each request pays the whole pipeline: on the exact tier the fused cold
program (ASSEMBLE, POTRF/TRSM/TRAIL, the alpha solves, CROSS and the mean),
on the low-rank tier the Nystrom build and its head.
"""

from __future__ import annotations

from torch.profiler import record_function

from bench import program
from bench import work as yardstick


def prepare(ctx) -> None:
    pass


def warmup(ctx) -> None:
    for i in range(ctx.mix["warmup_requests"]):
        request(ctx, i, None)


def next_input(ctx, i):
    return None


def request(ctx, i, inp):
    k = i % len(ctx.pool)
    x, y = ctx.pool[k]
    with record_function("bench.gp_init"):
        gp = program.make_gp(ctx.cfg, x, y, ctx.device)
    with record_function("bench.predict"):
        mean = gp.predict(ctx.tests[0])
    return {"dataset": k, "test": 0, "mean": mean}


def units(ctx):
    return {"points": ctx.tests[0].shape[0], "steps": 1}


def work(cfg, mix):
    if cfg["method"] == "lowrank":
        return yardstick.cold_lowrank(cfg["n_train"], cfg["n_test"], cfg["n_features"], cfg["m_inducing"])
    return yardstick.cold_exact(cfg["n_train"], cfg["n_test"], cfg["n_features"])


def cache_ok(counters, n):
    cold = counters.get("cache.posterior.cold", 0) + counters.get("cache.lowrank.cold", 0)
    warm = counters.get("cache.posterior.warm", 0) + counters.get("cache.lowrank.warm", 0)
    return cold == n and warm == 0, f"{cold:g} cold and {warm:g} warm posterior builds in {n} requests"


def release(ctx) -> None:
    pass
