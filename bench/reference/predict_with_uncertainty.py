"""The warm mean and variance: an exact GP by dense Cholesky, at every row of each test set."""

from __future__ import annotations

from bench.reference import gp, rel_max_gap, rel_rms_gap


def expected(pool, tests, cfg, mix, keys):
    out = {}
    for k, j in keys:
        x, y = pool[k]
        mean, var = gp.exact_posterior(x, y, tests[j], cfg["params"], with_var=True)
        out[k, j] = {"mean": mean, "var": var}
    return out


def gaps(cfg, mix, outputs, want):
    """mean_err and var_err: the widest gap of a request's mean (variance), over the largest |mean|
    (variance) of the reference on its test set; mean_rms and var_rms: the root-mean-square gap over
    the reference's root mean square."""
    worst = {"mean_err": 0.0, "var_err": 0.0, "mean_rms": 0.0, "var_rms": 0.0}
    for o in outputs:
        ref = want[o["dataset"], o["test"]]
        for key in ("mean", "var"):
            gap = rel_max_gap(o.get(key), ref[key], float(ref[key].abs().max()))
            worst[f"{key}_err"] = max(worst[f"{key}_err"], gap)
            worst[f"{key}_rms"] = max(worst[f"{key}_rms"], rel_rms_gap(o.get(key), ref[key]))
    return worst


def as_outputs(want, keys):
    return [{"dataset": k, "test": j, "mean": want[k, j]["mean"], "var": want[k, j]["var"]} for k, j in keys]
