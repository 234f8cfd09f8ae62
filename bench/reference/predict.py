"""The cold mean: an exact GP by dense Cholesky, or the DTC mean over the strided subset of inducing points."""

from __future__ import annotations

from bench.reference import gp, rel_max_gap, rel_rms_gap


def expected(pool, tests, cfg, mix, keys):
    out = {}
    for k, j in keys:
        x, y = pool[k]
        if cfg["method"] == "lowrank":
            mean = gp.dtc_mean(x, y, tests[j], cfg["params"], cfg["m_inducing"], cfg["jitter"])
        else:
            mean = gp.exact_posterior(x, y, tests[j], cfg["params"], with_var=False)[0]
        out[k, j] = {"mean": mean}
    return out


def gaps(cfg, mix, outputs, want):
    """mean_err: the widest gap of a predicted mean, over the largest |mean| of the reference;
    mean_rms: the root-mean-square gap over the reference's root mean square."""
    worst = {"mean_err": 0.0, "mean_rms": 0.0}
    for o in outputs:
        ref = want[o["dataset"], o["test"]]["mean"]
        worst["mean_err"] = max(worst["mean_err"], rel_max_gap(o.get("mean"), ref, float(ref.abs().max())))
        worst["mean_rms"] = max(worst["mean_rms"], rel_rms_gap(o.get("mean"), ref))
    return worst


def as_outputs(want, keys):
    return [{"dataset": k, "test": j, "mean": want[k, j]["mean"]} for k, j in keys]
