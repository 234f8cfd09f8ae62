"""``GaussianProcess.optimize``: a new GP on the next dataset of the pool, fitted by Adam.

Each request starts from the configuration's hyperparameters and takes
``steps`` Adam steps on the tiled NLML: the fused forward program, K^-1
from the factor and the gradient contraction.  So every request does the
same work and the reference can repeat any of them.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from bench import program
from bench import work as yardstick


def prepare(ctx) -> None:
    pass


def warmup(ctx) -> None:
    for i in range(ctx.mix["warmup_requests"]):
        _fit(ctx, i, ctx.mix["warmup_steps"])


def next_input(ctx, i):
    return None


def _fit(ctx, i, steps):
    k = i % len(ctx.pool)
    x, y = ctx.pool[k]
    with record_function("bench.gp_init"):
        gp = program.make_gp(ctx.cfg, x, y, ctx.device)
    with program.loss_curves() as curves, record_function("bench.optimize"):
        gp.optimize(steps=steps, lr=ctx.mix["lr"])
    p = gp.params
    return {"dataset": k, "losses": curves[0], "params": torch.stack([torch.as_tensor(v) for v in (p.lengthscale, p.vertical, p.noise)])}


def request(ctx, i, inp):
    return _fit(ctx, i, ctx.mix["steps"])


def units(ctx):
    return {"points": 0, "steps": ctx.mix["steps"]}


def work(cfg, mix):
    step = yardstick.train_step(cfg["n_train"], cfg["n_features"])
    return {k: v * mix["steps"] for k, v in step.items()}


def cache_ok(counters, n):
    warm = counters.get("cache.posterior.warm", 0)
    return warm == 0, f"{warm:g} warm posterior reads in {n} requests (a fit reads no cache)"


def release(ctx) -> None:
    pass
