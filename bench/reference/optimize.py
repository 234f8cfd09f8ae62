"""The fit: Adam on the exact NLML with its closed-form gradient, from the configuration's hyperparameters."""

from __future__ import annotations

import statistics

import torch

from bench.reference import INF, gp


def expected(pool, tests, cfg, mix, keys):
    out = {}
    for k, j in keys:
        x, y = pool[k]
        theta0 = torch.tensor([cfg["params"][n] for n in gp.NAMES], dtype=x.dtype, device=x.device)
        losses, theta, g0 = gp.adam(x, y, theta0, mix["steps"], mix["lr"])
        out[k, j] = {"losses": losses, "params": theta, "theta0": theta0, "grad0": g0, "n": x.shape[0]}
    return out


def gaps(cfg, mix, outputs, want):
    """loss_gap: the widest gap of a step's NLML, in nats a training row.
    param_gap: the widest gap of a fitted hyperparameter, over the reference's change of it or the
    median leaf's change, whichever is larger; a leaf whose first reference gradient is under a
    thousandth of the median leaf's moves by round-off alone and is left out."""
    loss_gap, param_gap = 0.0, 0.0
    for o in outputs:
        ref = want[o["dataset"], o.get("test", 0)]
        got_l, got_p = o.get("losses"), o.get("params")
        if got_l is None or got_p is None or got_l.shape != ref["losses"].shape or got_p.shape != ref["params"].shape:
            return {"loss_gap": INF, "param_gap": INF}
        dl = float((got_l.double().cpu() - ref["losses"].double().cpu()).abs().max()) / ref["n"]
        change = (ref["params"] - ref["theta0"]).double().abs().cpu().tolist()
        grad = ref["grad0"].double().abs().cpu().tolist()
        gap = (got_p.double().cpu() - ref["params"].double().cpu()).abs().tolist()
        g_med, c_med = statistics.median(grad), statistics.median(change)
        dp = max((gap[i] / max(change[i], c_med) for i in range(len(gap)) if grad[i] >= 1e-3 * g_med), default=0.0)
        loss_gap = max(loss_gap, dl if dl == dl else INF)
        param_gap = max(param_gap, dp if dp == dp else INF)
    return {"loss_gap": loss_gap, "param_gap": param_gap}


def as_outputs(want, keys):
    return [{"dataset": k, "test": j, "losses": want[k, j]["losses"], "params": want[k, j]["params"]} for k, j in keys]
