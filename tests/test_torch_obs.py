"""Port parity: the telemetry (``repro_torch.obs``) and its instrumentation against the JAX package's.

The cases of ``tests/test_obs.py`` but the serving loop's (those are in
``tests/test_torch_serve.py``): registry semantics, export, the executor's
wave events, plan-cache statistics, the health counters, the jitter retry,
"disabled is bitwise invisible", and the drift monitor.  The registry and
the monitor are pure Python, so each sequence runs through both packages
and their outputs must be equal (the Prometheus text byte for byte).  The
instrumented GP runs on CPU tensors; its counters must equal the
reference's for the same calls, but for ``executor.traces.*`` (the
reference's count of JAX retraces, which eager torch has no counterpart of).
"""

import json
import math

import numpy as np
import pytest
import torch

import repro.obs as jobs
from _torch_threads import one_torch_thread  # noqa: F401
import repro_torch.obs as obs
from repro.core import GaussianProcess as JGP
from repro.core.kernels_math import SEKernelParams as JParams
from repro_torch.core import GaussianProcess, SEKernelParams
from repro_torch.core import executor
from repro_torch.core import predict as pred
from repro_torch.core import update as upd

PARAMS = dict(lengthscale=0.6, vertical=1.1, noise=0.05)
CPU = "cpu"
BOTH = (jobs, obs)


@pytest.fixture(autouse=True)
def _clean_registry():
    """Every test starts disabled and empty, and leaves no global state, in both packages."""
    for o in BOTH:
        o.disable()
        o.reset()
    yield
    for o in BOTH:
        o.disable()
        o.reset()


def _gp(x, y, **kw):
    return GaussianProcess(x, y, params=SEKernelParams(**PARAMS), tile_size=16, device=CPU, **kw)


def _no_traces(counters):
    return {k: v for k, v in counters.items() if not k.startswith("executor.traces.")}


# -- registry semantics ------------------------------------------------------


def test_counter_gauge_semantics():
    for o in BOTH:
        o.enable()
        o.inc("a")
        o.inc("a", 4)
        o.set_gauge("g", 2.5)
        o.set_gauge("g", 7.0)  # a gauge keeps the last write only
    snap = obs.snapshot()
    assert snap["counters"]["a"] == 5.0 and snap["gauges"]["g"] == 7.0
    assert (snap["counters"], snap["gauges"]) == (jobs.snapshot()["counters"], jobs.snapshot()["gauges"])


def test_disabled_helpers_record_nothing():
    obs.inc("a")
    obs.observe("h", 1.0)
    obs.event("e", x=1)
    obs.health_event("boom")
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["histograms"] == {} and snap["events"] == []
    obs.enable()  # recording resumes on the same registry
    obs.inc("a")
    assert obs.snapshot()["counters"]["a"] == 1.0


def test_histogram_percentiles_tiny_samples():
    h, hj = obs.Histogram(obs.DEFAULT_EDGES), jobs.Histogram(jobs.DEFAULT_EDGES)
    assert math.isnan(h.percentile(50))  # empty -> NaN, not garbage
    h.observe(3.0)
    assert h.percentile(0) == h.percentile(50) == h.percentile(99) == 3.0
    for v in (3.0, 5.0, 100.0):
        hj.observe(v)
    h.observe(5.0)
    h.observe(100.0)
    qs = [h.percentile(q) for q in (1, 25, 50, 75, 99)]
    assert qs == sorted(qs) and qs[0] >= 3.0 and qs[-1] <= 100.0  # monotone, clamped to the observed range
    assert qs == [hj.percentile(q) for q in (1, 25, 50, 75, 99)] and h.to_dict() == hj.to_dict()


def test_histogram_overflow_bucket_and_sum():
    h = obs.Histogram(edges=(1.0, 2.0))
    for v in (0.5, 1.5, 99.0):
        h.observe(v)
    assert h.counts == [1, 1, 1]  # the last is the implicit +inf bucket
    assert h.sum == pytest.approx(101.0) and h.count == 3 and h.percentile(99) <= 99.0


def test_event_ring_buffer_caps_memory():
    obs.enable()
    for i in range(obs.MAX_EVENTS + 10):
        obs.event("e", i=i)
    events = obs.registry().events
    assert len(events) == obs.MAX_EVENTS == jobs.MAX_EVENTS
    assert events[0]["i"] == 10  # the oldest dropped


# -- export ------------------------------------------------------------------


def test_jsonl_sink_round_trip(tmp_path):
    path = tmp_path / "m.jsonl"
    obs.enable(str(path))
    obs.event("alpha", v=1)
    obs.event("beta", v=[1, 2])
    obs.disable()  # closes the sink
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["alpha", "beta"]
    assert all("ts" in r for r in recs) and recs[1]["v"] == [1, 2]


def test_to_json_and_prometheus():
    for o in BOTH:
        o.enable()
        o.inc("serve.requests", 3)
        o.set_gauge("pool.occupancy", 0.5)
        o.observe("lat_ms", 2.0, edges=(1.0, 4.0))
    assert json.loads(obs.to_json())["counters"]["serve.requests"] == 3.0
    prom = obs.to_prometheus()
    assert prom == jobs.to_prometheus()  # the same exposition, byte for byte
    for line in ("# TYPE repro_serve_requests counter", "repro_serve_requests 3", "repro_pool_occupancy 0.5",
                 'repro_lat_ms_bucket{le="4"} 1', 'repro_lat_ms_bucket{le="+Inf"} 1', "repro_lat_ms_count 1"):
        assert line in prom


# -- executor wave traces ----------------------------------------------------


def test_plan_wave_stats_shape():
    from repro.core import executor as jex

    plan = executor.program_plan(4, 1, False, 2)
    st = executor.plan_wave_stats(plan)
    assert st == jex.plan_wave_stats(jex.program_plan(4, 1, False, 2))
    assert st["plan"] == "program" and st["n_streams"] == 2
    assert st["tasks"] == st["bulk_tasks"] + st["pool_tasks"]
    assert 0.0 < st["occupancy"] <= 1.0 and sum(st["by_op"].values()) == st["tasks"]
    assert executor.plan_wave_stats(plan) is st  # memoized per Plan


def test_fused_predict_and_update_count_as_the_reference(rng):
    """Cold fused predict, a warm tail, a warm append, a warm tail: the same counters and wave events."""
    x = rng.standard_normal((40, 2)).astype(np.float32)
    y = rng.standard_normal(40).astype(np.float32)
    xn = rng.standard_normal((16, 2)).astype(np.float32)
    yn = rng.standard_normal(16).astype(np.float32)
    for o, gp in ((jobs, JGP(x, y, params=JParams(**PARAMS), tile_size=16)), (obs, _gp(x, y))):
        o.enable()
        gp.predict(x[:4])
        if o is obs:
            snap = obs.snapshot()
            assert snap["counters"]["executor.dispatch.run_program"] == 1.0
            assert snap["counters"]["cache.posterior.cold"] == 1.0
            (ev,) = [e for e in snap["events"] if e["kind"] == "executor.wave"]
            assert ev["dispatch"] == "run_program" and ev["plan"] == "program" and ev["backend"] == "cpu"
            assert ev["launches"] > 0 and ev["tasks"] > 0
        gp.predict(x[:4])  # the warm tail: no new program dispatch
        gp.update(xn, yn)
        gp.predict(x[:4])
    c = obs.snapshot()["counters"]
    assert c["executor.dispatch.run_program"] == 1.0 and c["predict.warm_tail"] == 2.0
    assert c["cache.posterior.warm"] == 2.0 and c["executor.dispatch.run_append"] >= 1
    assert c == _no_traces(jobs.snapshot()["counters"])
    waves = [{k: v for k, v in e.items() if k not in ("ts", "backend")} for e in obs.snapshot()["events"]]
    assert waves == [{k: v for k, v in e.items() if k not in ("ts", "backend")} for e in jobs.snapshot()["events"]]


def test_cache_stats_reports_plan_caches():
    executor.program_plan(4, 1, False, 2)
    stats = obs.cache_stats()
    assert set(stats) == {f"executor.{p}_plan" for p in ("cholesky", "solve", "program", "lowrank",
                                                         "update_append", "update_rank")}
    st = stats["executor.program_plan"]
    assert set(st) == {"hits", "misses", "size"} and st["size"] >= 1
    executor.program_plan(4, 1, False, 2)  # an lru hit
    assert obs.cache_stats()["executor.program_plan"]["hits"] == st["hits"] + 1


# -- factorization health ----------------------------------------------------


@pytest.mark.parametrize("method", ["exact", "lowrank"])
def test_refactorize_fallback_counter(rng, monkeypatch, method):
    x = rng.standard_normal((32, 2)).astype(np.float32)
    y = rng.standard_normal(32).astype(np.float32)
    gp = _gp(x, y, method=method, m_inducing=8 if method == "lowrank" else None)
    gp.predict(x[:2])

    def boom(*a, **k):
        raise upd.CholeskyUpdateError("forced")

    if method == "exact":
        monkeypatch.setattr(pred.PosteriorState, "extend", boom)
    else:
        monkeypatch.setattr("repro_torch.core.lowrank.absorb", boom)
    obs.enable()
    gp.update(rng.standard_normal((8, 2)).astype(np.float32), rng.standard_normal(8).astype(np.float32))
    snap = obs.snapshot()
    assert snap["counters"]["health.refactorize_fallback"] == 1.0
    (ev,) = [e for e in snap["events"] if e["kind"] == "health.refactorize_fallback"]
    assert ev["site"] == ("gp.update" if method == "exact" else "gp.update.lowrank")
    assert gp._posterior is None and gp._lowrank is None  # the contract: the cache is invalidated


def test_nan_guard_trip_counter():
    obs.enable()
    with pytest.raises(upd.CholeskyUpdateError):
        upd._check(torch.tensor([float("nan")]), "append")
    assert obs.snapshot()["counters"]["health.nan_guard_trip"] == 1.0


def test_lowrank_jitter_retry_recovers(rng):
    """Duplicate inducing rows and zero jitter: K_uu is singular, the cold factorization goes
    non-finite, and the escalating-jitter retry recovers, counted as the reference counts it."""
    x = np.repeat(rng.standard_normal((4, 2)), 8, axis=0).astype(np.float32)
    y = rng.standard_normal(32).astype(np.float32)
    ind = np.repeat(x[:1], 8, axis=0)  # 8 identical inducing points
    obs.enable()
    gp = _gp(x, y, method="lowrank", m_inducing=8, inducing=ind, jitter=0.0)
    assert torch.isfinite(gp.predict(x[:4])).all()
    c = obs.snapshot()["counters"]
    assert c["health.lowrank_jitter_retry"] >= 1.0 and c["cache.lowrank.cold"] == 1.0


# -- nothing recorded when off -----------------------------------------------


@pytest.mark.parametrize("method", ["exact", "lowrank"])
def test_disabled_obs_is_bitwise_invisible(rng, method):
    x = rng.standard_normal((48, 2)).astype(np.float32)
    y = rng.standard_normal(48).astype(np.float32)
    xt = rng.standard_normal((8, 2)).astype(np.float32)

    def run():
        gp = _gp(x, y, method=method, m_inducing=16 if method == "lowrank" else None)
        return gp.predict_with_uncertainty(xt)

    base = run()
    obs.enable()
    on = run()
    obs.disable()
    off = run()
    for a, b, c in zip(base, on, off):
        assert torch.equal(a, b) and torch.equal(a, c)
    # disable stops recording but keeps the data, and reset wipes it without touching the flag
    key = "cache.posterior.cold" if method == "exact" else "cache.lowrank.cold"
    assert obs.snapshot()["counters"][key] == 1.0
    obs.reset()
    assert obs.snapshot()["counters"] == {}


# -- drift monitor -----------------------------------------------------------


def test_drift_monitor_stationary_never_triggers():
    stream = 1.0 + 0.01 * np.random.default_rng(0).standard_normal(200)
    mons = [o.DriftMonitor(alpha=0.3, threshold=0.05, warmup=3, cooldown=8) for o in BOTH]
    fired = [[m.observe(v) for v in stream] for m in mons]
    assert fired[0] == fired[1] and not any(fired[1])
    assert mons[1].triggers == 0 and mons[1].level == pytest.approx(1.0, abs=0.05)
    assert mons[1].level == mons[0].level and mons[1].trend == mons[0].trend


def test_drift_monitor_rising_triggers_once():
    mons = [o.DriftMonitor(alpha=0.5, threshold=0.05, warmup=2, cooldown=10 ** 6) for o in BOTH]
    fired = [[i for i in range(50) if m.observe(1.0 + 0.2 * i)] for m in mons]
    assert fired[0] == fired[1] and len(fired[1]) == 1 and mons[1].triggers == 1  # cooldown gates repeats
    mons[1].reset()
    assert mons[1].level is None and mons[1].triggers == 1  # the lifetime statistic survives


def test_drift_monitor_ignores_nan_and_respects_warmup():
    mon = obs.DriftMonitor(alpha=0.5, threshold=0.01, warmup=5, cooldown=0)
    assert mon.observe(float("nan")) is False
    assert mon.level is None  # NaN never becomes the level
    assert not any(mon.observe(1.0 + i) for i in range(4))  # inside the warmup


def test_span_is_a_profiler_range_only_when_enabled():
    assert obs.span("x") is obs.span("y")  # the shared no-op when off
    obs.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.Tracer("repro_torch.test").span("wave"):
            torch.ones(4).sum()
    assert any(e.name == "repro_torch.test.wave" for e in prof.events())
