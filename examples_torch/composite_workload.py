"""Composite kernels through the tiled pipeline on the PyTorch/CUDA port: C * Matern52 + White.

The ARBO-style surrogate — an output-scaled Matérn 5/2 plus an explicit
white-noise term — built from the kernel zoo's composition algebra, trained
via the tiled NLML (the autodiff route: the composite has no analytic rule),
and served through a predict-observe-update loop where each round's new
observations are absorbed online by the block Cholesky append (no
re-factorization).  `repro_torch.obs` telemetry is on for the whole run;
the tail prints what the loop actually did — warm vs cold posterior builds,
executor dispatches, factorization-health incidents, and the plan-cache
tallies.

    PYTHONPATH=src python examples_torch/composite_workload.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import GaussianProcess, Matern52, Scaled, Sum, White
from repro_torch.device import resolve_device
from repro_torch.kernels import build_kernels


def f(x):  # the function being surrogate-modeled
    return np.sin(3.0 * x[:, 0]) * np.cos(2.0 * x[:, 1])


def _mae(mean, x_test) -> float:
    return float(np.abs(mean.cpu().numpy() - f(x_test)).mean())


def run(device="cuda", *, n=192, n_test=128, tile=64, steps=60, lr=0.1, rounds=3, arrive=32, seed=0,
        log=print) -> dict:
    """The reference's composite workload; returns what it prints, its first data, the predictions and the trained
    params."""
    dev = resolve_device(device)
    build_s = build_kernels(dev)
    if dev.type == "cuda":
        log(f"kernels built and loaded: {build_s:.2f}s")
    obs.reset()  # the counters of this run alone, as in a fresh process
    obs.enable()
    try:
        rng = np.random.default_rng(seed)
        x_train = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        y_train = (f(x_train) + 0.05 * rng.standard_normal(n)).astype(np.float32)
        x_test = rng.uniform(-1, 1, (n_test, 2)).astype(np.float32)

        # kernel algebra: Sum / Product / Scaled compose over nested params
        # trees; the composite is hashable, so it keys the plan and posterior caches
        kernel = Sum(Scaled(Matern52()), White())
        gp = GaussianProcess(x_train, y_train, tile_size=tile, kernel=kernel, device=dev)

        mean, var = gp.predict_with_uncertainty(x_test)
        out = dict(build_s=build_s, x_train=x_train, y_train=y_train, x_test=x_test, mean=mean, var=var,
                   mae=_mae(mean, x_test), avg_std=float(torch.sqrt(var).mean()))
        log(f"untrained composite:  mae={out['mae']:.4f}  avg std={out['avg_std']:.4f}")

        # tiled NLML + Adam over the full params tree (scale, Matérn, noise leaves)
        gp.optimize(steps=steps, lr=lr)
        mean, var = gp.predict_with_uncertainty(x_test)
        out.update(params=gp.params, mean_trained=mean, mae_trained=_mae(mean, x_test),
                   avg_std_trained=float(torch.sqrt(var).mean()))
        log(f"after NLML training:  mae={out['mae_trained']:.4f}  avg std={out['avg_std_trained']:.4f}")

        # predict-observe-update: each round streams fresh observations into
        # the cached factor via the tiled block Cholesky append
        out["rounds"] = []
        for round_idx in range(rounds):
            x_new = rng.uniform(-1, 1, (arrive, 2)).astype(np.float32)
            y_new = (f(x_new) + 0.05 * rng.standard_normal(arrive)).astype(np.float32)
            gp.update(x_new, y_new)
            mean, _ = gp.predict_with_uncertainty(x_test)
            out["rounds"].append(dict(n=int(gp.y_train.shape[0]), mae=_mae(mean, x_test)))
            log(f"round {round_idx}: n={gp.y_train.shape[0]}  mae={out['rounds'][-1]['mae']:.4f}")
        out["mean_final"] = mean

        # what the loop did, from the telemetry registry
        c = obs.snapshot()["counters"]
        out["counters"] = dict(c)
        out["warm"], out["cold"] = c.get("cache.posterior.warm", 0), c.get("cache.posterior.cold", 0)
        out["dispatches"] = sum(v for k, v in c.items() if k.startswith("executor.dispatch."))
        out["health"] = sum(v for k, v in c.items() if k.startswith("health."))
        log(f"obs: posterior cache warm={out['warm']:.0f} cold={out['cold']:.0f}, executor dispatches="
            f"{out['dispatches']:.0f}, health incidents={out['health']:.0f}")
        log("obs: cache stats:")
        out["cache_stats"] = {}
        for name, st in obs.cache_stats().items():
            if st["hits"] or st["misses"]:
                out["cache_stats"][name] = st
                log(f"  {name}: hits={st['hits']} misses={st['misses']} size={st['size']}")
    finally:
        obs.disable()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    run(args.device)


if __name__ == "__main__":
    main()
