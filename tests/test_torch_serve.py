"""Port parity: the serving loop (``repro_torch.serve.ContinuousBatcher``) against the JAX package.

The cases of ``tests/test_ragged.py``'s batcher (waves, dispatch ordering),
``tests/test_lowrank.py``'s low-rank bucket, and ``tests/test_obs.py``'s
serving cells (summary, wave accounting, drift-triggered re-optimize).  Two
problems of 40 and 60 points in D = 2; the exact tier at tile 32 (the
reference's cells), the low-rank one at tile 16, m_inducing 16 with a
pinned inducing set.  Each request's result is held against the JAX
package's single GP on the same data (computed once, in a module-scoped
fixture) at the reference cells' tolerances (3e-4 before an update, 1e-3
exact and 3e-3 low-rank after it), and bitwise against a synchronous
``predict_each`` of the port on the same snapshot.
"""

import math

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
import repro_torch.obs as obs
from repro.core import GaussianProcess as JGP
from repro.core.kernels_math import SEKernelParams as JParams
from repro_torch.core import GPFleet, SEKernelParams
from repro_torch.serve import ContinuousBatcher

CPU = "cpu"
PARAMS = dict(lengthscale=0.6, vertical=1.1, noise=0.05)
TIERS = {"exact": dict(tile_size=32), "lowrank": dict(tile_size=16, method="lowrank", m_inducing=16)}
AFTER_TOL = {"exact": 1e-3, "lowrank": 3e-3}


def _data():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((n, 2)).astype(np.float32) for n in (40, 60)]
    ys = [rng.standard_normal(n).astype(np.float32) for n in (40, 60)]
    xt = rng.standard_normal((4, 2)).astype(np.float32)
    xo = rng.standard_normal((30, 2)).astype(np.float32)  # 60 + 30 crosses the 2-tile (exact) / 4-tile boundary
    yo = rng.standard_normal(30).astype(np.float32)
    u = rng.standard_normal((16, 2)).astype(np.float32)
    return xs, ys, xt, xo, yo, u


def _kw(tier, u):
    kw = dict(TIERS[tier])
    if tier == "lowrank":
        kw["inducing"] = u
    return kw


def _fleet(tier, xs=None, ys=None):
    d = _data()
    return GPFleet(d[0] if xs is None else xs, d[1] if ys is None else ys, params=SEKernelParams(**PARAMS),
                   device=CPU, **_kw(tier, d[5]))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's single GPs: each problem before, and after, its wave's observations."""
    xs, ys, xt, xo, yo, u = _data()
    out = {}
    for tier in TIERS:
        kw = dict(params=JParams(**PARAMS), **_kw(tier, u))
        g0 = JGP(xs[0], ys[0], **kw)
        out[tier] = dict(
            g0=np.asarray(g0.predict(xt)),
            g1_grown=np.asarray(JGP(np.concatenate([xs[1], xo]), np.concatenate([ys[1], yo]), **kw).predict(xt)),
            g0_grown=np.asarray(JGP(np.concatenate([xs[0], xo[:8]]), np.concatenate([ys[0], yo[:8]]), **kw).predict(xt)),
        )
    return out


def _close(got, want, tol):
    assert np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))) <= tol


@pytest.fixture(autouse=True)
def _clean_registry():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_continuous_batcher_waves(ref, tier):
    """Observes land before predicts in a wave; both requests on problem 0 share one launch and slice
    their own rows back out; a migrating update; results equal the reference's single GPs."""
    xs, ys, xt, xo, yo, _ = _data()
    fleet = _fleet(tier)
    ticks = iter(range(1000))
    srv = ContinuousBatcher(fleet, clock=lambda: float(next(ticks)))
    r1 = srv.submit_predict(0, xt)
    r2 = srv.submit_predict(0, xt[:2], uncertainty=True)
    r3 = srv.submit_observe(1, xo, yo)
    assert srv.pending == 3
    before = fleet.bucket_assignment()
    stats = srv.step()
    assert srv.pending == 0
    assert (stats.n_predict, stats.n_observe, stats.points_absorbed, stats.migrations) == (2, 1, 30, 1)
    assert fleet.bucket_assignment() != before and stats.buckets == tuple(sorted(fleet.bucket_assignment()))
    got1 = srv.result(r1)
    _close(got1, ref[tier]["g0"], 3e-4)
    m2, v2 = srv.result(r2)
    _close(m2, ref[tier]["g0"][:2], 3e-4)
    assert (v2 >= 0).all()
    assert srv.result(r3) == 30
    with pytest.raises(KeyError):
        srv.result(r3)  # results pop exactly once
    # bitwise: the batcher's rows are those of a synchronous predict_each on the same snapshot
    sync = fleet.predict_each([np.concatenate([xt, xt[:2]]), np.zeros((0, 2), np.float32)], full_cov=True)
    assert torch.equal(got1, sync[0][0][:4]) and torch.equal(m2, sync[0][0][4:])
    assert torch.equal(v2, torch.diagonal(sync[0][1])[4:])
    s = srv.summary()
    assert s["requests"] == 3.0 and s["waves"] == 1.0 and s["p99_ms"] >= s["p50_ms"] >= 0.0
    rid = srv.submit_predict(1, xt)
    srv.run_until_idle()
    _close(srv.result(rid), ref[tier]["g1_grown"], AFTER_TOL[tier])


def test_continuous_batcher_dispatch_overlap_ordering(ref):
    """Waves dispatch without waiting; results arrive one wave late but are computed against the
    snapshot at dispatch time: wave N's predictions see waves 0..N's observations."""
    xs, ys, xt, xo, yo, _ = _data()
    srv = ContinuousBatcher(_fleet("exact"))
    r0 = srv.submit_predict(0, xt)
    assert srv.step().n_predict == 1
    assert srv._inflight is not None and r0 not in srv._done  # dispatched, not fetched
    srv.submit_observe(0, xo[:8], yo[:8])
    r1 = srv.submit_predict(0, xt)
    srv.step()
    assert r0 in srv._done and r1 not in srv._done  # one wave late, now finished
    _close(srv.result(r0), ref["exact"]["g0"], 3e-4)
    _close(srv.result(r1), ref["exact"]["g0_grown"], 1e-3)  # result() flushes the wave in flight
    assert srv._inflight is None and srv.flush() == 0  # idempotent when drained


def test_summary_empty_and_single_request_nan_safe():
    srv = ContinuousBatcher(_fleet("exact"))
    s = srv.summary()
    assert s["requests"] == 0.0
    for k in ("p50_ms", "p99_ms", "max_ms", "req_per_s"):
        assert math.isfinite(s[k]) and s[k] >= 0.0
    srv.submit_predict(0, np.zeros((3, 2), np.float32))
    srv.step()
    srv.flush()
    s = srv.summary()
    assert s["requests"] == 1.0 and math.isfinite(s["p99_ms"])
    assert s["max_ms"] >= s["p99_ms"] >= s["p50_ms"] > 0.0


def test_serve_wave_metrics_and_events():
    _, _, xt, xo, yo, _ = _data()
    srv = ContinuousBatcher(_fleet("exact"))
    obs.enable()
    for i in range(2):
        srv.submit_predict(i, xt)
    srv.submit_observe(0, xo[:3], yo[:3])
    srv.step()
    srv.flush()
    (ev,) = [e for e in obs.registry().events if e["kind"] == "serve.wave"]
    assert ev["n_predict"] == 2 and ev["n_observe"] == 1
    assert 0.0 < ev["bucket_occupancy"] <= 1.0 and 0.0 <= ev["padded_flop_waste"] < 1.0
    snap = srv.metrics_snapshot()
    assert snap["counters"]["serve.waves"] == 1.0 and snap["counters"]["serve.points_absorbed"] == 3.0
    assert snap["histograms"]["serve.queue_depth"]["count"] == 1
    obs.disable()  # the private registry works with global telemetry off
    srv.submit_predict(0, xt)
    srv.step()
    assert srv.metrics_snapshot()["counters"]["serve.waves"] == 2.0
    assert len([e for e in obs.registry().events if e["kind"] == "serve.wave"]) == 1


def _drifting_waves(srv, problems, rng, waves=6):
    """Observes whose targets climb wave over wave: the NLML per point rises."""
    reopt = 0
    for w in range(waves):
        for i in range(problems):
            srv.submit_observe(i, rng.uniform(size=(2, 2)).astype(np.float32), np.full(2, 3.0 * w, np.float32))
        reopt += srv.step().reoptimized
    srv.flush()
    return reopt


def test_drift_triggers_exactly_one_reoptimize():
    mon = obs.DriftMonitor(alpha=0.5, threshold=0.02, warmup=1, cooldown=10 ** 6)
    calls = []
    srv = ContinuousBatcher(_fleet("exact"), drift_monitor=mon, reoptimize=lambda: calls.append(1))
    obs.enable()
    assert _drifting_waves(srv, 2, np.random.default_rng(1)) == 1
    assert len(calls) == 1 and mon.triggers == 1  # exactly one re-optimize (the cooldown holds)
    assert srv.summary()["reoptimizations"] == 1.0
    assert obs.snapshot()["counters"]["health.serve_reoptimize"] == 1.0


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_drift_default_reoptimize_fits_fleet(tier):
    """The default re-optimize is ``fleet.optimize()`` on the fleet's tier: new per-problem leaves, and
    serving goes on against the refitted fleet."""
    fleet = _fleet(tier)
    mon = obs.DriftMonitor(alpha=0.5, threshold=0.02, warmup=1, cooldown=10 ** 6)
    srv = ContinuousBatcher(fleet, drift_monitor=mon, reoptimize=None)
    fleet.optimize = lambda steps=3, lr=0.05, _fit=fleet.optimize: _fit(steps=steps, lr=lr)  # fewer steps, same fit
    _drifting_waves(srv, 2, np.random.default_rng(2))
    assert mon.triggers == 1 and fleet.params.lengthscale.shape == (2,)
    rid = srv.submit_predict(0, np.zeros((3, 2), np.float32))
    srv.step()
    assert torch.isfinite(srv.result(rid)).all()


def test_fleet_optimize_improves_nlml():
    fleet = _fleet("exact")
    n0 = fleet.nlml()
    fleet.optimize(steps=30, lr=0.1)
    n1 = fleet.nlml()
    assert (n1 <= n0 + 1e-3).all() and n1.sum() < n0.sum()  # every problem at least as good, the fleet better
