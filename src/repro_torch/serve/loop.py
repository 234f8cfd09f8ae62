"""Wave-based continuous batching over a :class:`repro_torch.core.gp.GPFleet`.

The serving loop is synchronous: one host thread drains the request
queue in waves, as the host-side task graph of the paper does (the
asynchrony lives in the card's stream, not in Python threads).  One wave:

1. drain everything queued so far;
2. apply ALL observation requests as one ragged ``fleet.update``: bucket
   membership is recomputed, problems that outgrew their geometry migrate
   (exact tier: a ``blockdiag(L, I)`` re-embed; low-rank tier: a row
   gather), and every bucket absorbs its arrivals in one sweep;
3. *dispatch* ALL prediction requests through ``fleet.predict_each``: one
   warm batched call per occupied bucket, per-problem test counts masked
   with ``nt_valid``;
4. record per-request latencies (submit to results materialized).

Observations land before predictions inside a wave, so a wave's
predictions see its own wave's observations.

**Dispatch overlap.**  ``step`` never waits for the card after it has
dispatched the wave's predictions.  The results of every problem are
gathered into one device tensor, copied into pinned host memory by an
asynchronous copy on the same stream, and a CUDA event is recorded after
it.  The results are materialized ONE WAVE LATE: the event is synchronized
at the start of the next ``step``, or by :meth:`flush` / :meth:`result` /
the tail of :meth:`run_until_idle`, while the host prepares the next wave
in between.  On the CPU the same code runs with no event.

**Ordering.**  The card runs one stream in issue order, so a later wave's
update, whose launches are issued after the in-flight wave's predictions
and its copy, cannot overtake them; the copy's destination is a buffer of
its own that no update touches.  Wave N's predictions see exactly waves
0..N's observations, whenever their results are fetched.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

import repro_torch.obs as obs
from repro_torch.core import kernels_math as km
from repro_torch.core.gp import GPFleet

PREDICT = "predict"
OBSERVE = "observe"


@dataclasses.dataclass
class Request:
    """One queued unit of work against a single fleet problem."""

    rid: int
    kind: str                  # PREDICT | OBSERVE
    problem: int
    x: torch.Tensor            # test points (predict) or features (observe), as submitted (numpy -> host)
    y: Optional[torch.Tensor]  # targets (observe only)
    t_submit: float
    uncertainty: bool = False  # predict only: also return the variance diagonal
    t_done: Optional[float] = None
    result: object = None


@dataclasses.dataclass
class WaveStats:
    """What one call to :meth:`ContinuousBatcher.step` did."""

    wave: int
    n_predict: int             # predictions DISPATCHED this wave (not fetched)
    n_observe: int
    points_absorbed: int
    buckets: Tuple[int, ...]   # occupied cap_tiles AFTER the wave
    migrations: int            # problems whose bucket capacity changed
    duration_s: float          # host dispatch time (excludes the device's wait)
    reoptimized: bool = False  # the drift monitor fired and the re-optimize ran


@dataclasses.dataclass
class _InflightWave:
    """One dispatched, not yet fetched prediction wave."""

    per_problem: Dict[int, List[Request]]
    host: torch.Tensor                 # every problem's means, then variances, flat (pinned on the card)
    offsets: Dict[int, int]            # problem -> its first row in ``host``
    n_rows: int                        # rows of means (the variances follow)
    want_unc: bool
    d: int
    done: Optional[object] = None      # CUDA event after the copy, or None on the CPU


class ContinuousBatcher:
    """Drains request waves through a bucketed ragged GP fleet (either tier).

    ``clock`` is injectable for deterministic tests; it must be monotonic.
    Results are kept until :meth:`result` pops them; they are host tensors.

    **Accounting.**  The batcher keeps a private, always-on
    :class:`repro_torch.obs.Registry` for its own wave and latency
    accounting: :meth:`summary` reads it whether or not global telemetry is
    on.  With ``obs.enable()`` each wave also emits a ``serve.wave`` event
    (queue depth, bucket occupancy, padded-FLOP waste, ...).  Every value
    recorded is a host value.

    **Drift-triggered re-optimize.**  Given a
    :class:`repro_torch.obs.DriftMonitor`, the batcher feeds it the fleet's
    NLML per point after every wave that absorbed observations.  The NLML
    is computed right after the update and before the predictions are
    dispatched, and copied to the host asynchronously; the host reads it
    after the dispatch, so that read waits for the update and the NLML
    only, never for the wave's predictions.  When the monitor fires,
    ``reoptimize`` (default ``fleet.optimize()``) runs at the END of the
    wave, while the predictions are in flight, and the monitor is reset.
    """

    def __init__(
        self,
        fleet: GPFleet,
        *,
        clock: Callable[[], float] = time.perf_counter,
        drift_monitor: Optional[obs.DriftMonitor] = None,
        reoptimize: Optional[Callable[[], None]] = None,
    ):
        self.fleet = fleet
        self.clock = clock
        self.drift_monitor = drift_monitor
        self._reoptimize = reoptimize
        self._queue: List[Request] = []
        self._inflight: Optional[_InflightWave] = None
        self._done: Dict[int, Request] = {}
        self._next_rid = 0
        self._wave = 0
        self._t0 = clock()
        self._served = 0
        self._metrics = obs.Registry()  # private, always on (summary reads it)
        self._on_card = fleet.device.type == "cuda"

    # -- submission ---------------------------------------------------------

    def submit_predict(self, problem: int, x_test, *, uncertainty: bool = False) -> int:
        """Queue a prediction request; returns its request id."""
        return self._push(PREDICT, problem, torch.as_tensor(x_test), None, uncertainty)

    def submit_observe(self, problem: int, x_new, y_new) -> int:
        """Queue new observations for one problem; returns its request id."""
        return self._push(OBSERVE, problem, torch.as_tensor(x_new), torch.as_tensor(y_new).reshape(-1), False)

    def _push(self, kind, problem, x, y, uncertainty) -> int:
        if not 0 <= problem < self.fleet.batch_size:
            raise ValueError(f"problem must be in [0, {self.fleet.batch_size}); got {problem}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, kind, problem, x, y, self.clock(), uncertainty))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- the wave loop ------------------------------------------------------

    def _to_fleet(self, t: torch.Tensor) -> torch.Tensor:
        """A host block on the fleet's device, by a pinned asynchronous copy (no stream sync)."""
        return km._to_device(t.to(self.fleet.dtype), self.fleet.device)

    def _absorb(self, observes: List[Request]) -> int:
        """One ragged ``fleet.update`` of the wave's observations; returns the points absorbed."""
        b, d = self.fleet.batch_size, self.fleet._xs[0].shape[-1]
        xs: List[List[torch.Tensor]] = [[] for _ in range(b)]
        ys: List[List[torch.Tensor]] = [[] for _ in range(b)]
        absorbed = 0
        for r in observes:
            xs[r.problem].append(r.x.reshape(-1, d).to(self.fleet.dtype))
            ys[r.problem].append(r.y.to(self.fleet.dtype))
            absorbed += r.y.shape[0]
        empty_x = torch.zeros((0, d), dtype=self.fleet.dtype)
        empty_y = torch.zeros((0,), dtype=self.fleet.dtype)
        self.fleet.update(
            [self._to_fleet(torch.cat(px)) if px else empty_x for px in xs],
            [self._to_fleet(torch.cat(py)) if py else empty_y for py in ys],
        )
        return absorbed

    def _dispatch(self, predicts: List[Request]) -> _InflightWave:
        """Enqueue the wave's predictions and the copy of their results to the host; no wait."""
        d = self.fleet._xs[0].shape[-1]
        per_problem: Dict[int, List[Request]] = {}
        for r in predicts:
            per_problem.setdefault(r.problem, []).append(r)
        want_unc = any(r.uncertainty for r in predicts)
        empty = torch.zeros((0, d), dtype=self.fleet.dtype)
        tests = []
        for i in range(self.fleet.batch_size):
            reqs = per_problem.get(i, ())
            tests.append(
                self._to_fleet(torch.cat([r.x.reshape(-1, d).to(self.fleet.dtype) for r in reqs])) if reqs else empty
            )
        outs = self.fleet.predict_each(tests, full_cov=want_unc)
        offsets, means, variances, row = {}, [], [], 0
        for i in per_problem:
            offsets[i] = row
            row += tests[i].shape[0]
            if want_unc:
                means.append(outs[i][0])
                variances.append(torch.diagonal(outs[i][1]))
            else:
                means.append(outs[i])
        flat = torch.cat(means + variances)
        done = None
        if self._on_card:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = flat
        return _InflightWave(per_problem, host, offsets, row, want_unc, d, done)

    def _nlml_per_point(self):
        """The fleet's summed NLML, enqueued now and copied to the host asynchronously: (tensor, event)."""
        total = torch.sum(self.fleet.nlml()).reshape(1)
        if not self._on_card:
            return total, None
        host = torch.empty((1,), dtype=total.dtype, pin_memory=True)
        host.copy_(total, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def step(self) -> WaveStats:
        """Run one wave: materialize the PREVIOUS wave's dispatched predictions,
        absorb every queued observation, and dispatch every queued prediction
        (fetched one wave late, see the module docstring), re-forming buckets
        in between."""
        t0 = self.clock()
        self._metrics.histogram("serve.queue_depth", obs.COUNT_EDGES).observe(len(self._queue))
        self._metrics.histogram("serve.inflight_depth", obs.COUNT_EDGES).observe(
            0 if self._inflight is None else 1
        )
        self.flush()  # the previous wave's device work is done (or nearly) by now
        wave, self._queue = self._queue, []
        observes = [r for r in wave if r.kind == OBSERVE]
        predicts = [r for r in wave if r.kind == PREDICT]
        before = self._capacity_map()

        absorbed = self._absorb(observes) if observes else 0
        nlml = None
        if self.drift_monitor is not None and observes:
            nlml = self._nlml_per_point()
        if predicts:
            self._inflight = self._dispatch(predicts)

        t1 = self.clock()
        for r in observes:
            r.result = r.y.shape[0]
            self._finish(r, t1)
        after = self._capacity_map()
        migrations = sum(1 for i, c in after.items() if before.get(i) not in (None, c))
        self._wave += 1

        # training off the hot path: the predictions are in flight, so a
        # triggered re-optimize overlaps them and delays only the NEXT wave
        reoptimized = False
        if nlml is not None:
            total, ev = nlml
            if ev is not None:
                ev.synchronize()  # the update and the NLML only: the predictions come after
            nlml_pp = float(total[0]) / max(sum(self.fleet.sizes), 1)
            if self.drift_monitor.observe(nlml_pp):
                (self._reoptimize or self.fleet.optimize)()
                self.drift_monitor.reset()
                self._metrics.counter("serve.reoptimizations").inc()
                obs.health_event("serve_reoptimize", wave=self._wave - 1, nlml_per_point=nlml_pp)
                reoptimized = True

        m = self.fleet.tile_size
        sizes = self.fleet.sizes
        cap_n = {i: c * m for i, c in self._capacity_map().items()}
        occupancy = sum(sizes) / max(sum(cap_n.values()), 1)
        # the share of the warm tail's cross-covariance FLOPs (O(cap_n^2) a
        # problem) spent on padding rows
        waste = 1.0 - sum(n * n for n in sizes) / max(sum(c * c for c in cap_n.values()), 1)
        self._metrics.histogram("serve.wave_latency_ms").observe((t1 - t0) * 1e3)
        self._metrics.histogram("serve.bucket_occupancy", obs.FRACTION_EDGES).observe(occupancy)
        self._metrics.histogram("serve.padded_flop_waste", obs.FRACTION_EDGES).observe(waste)
        self._metrics.counter("serve.waves").inc()
        self._metrics.counter("serve.points_absorbed").inc(absorbed)
        self._metrics.counter("serve.migrations").inc(migrations)
        buckets = tuple(sorted(set(after.values())))
        if obs.enabled():
            obs.event(
                "serve.wave", wave=self._wave - 1, n_predict=len(predicts), n_observe=len(observes),
                points_absorbed=absorbed, migrations=migrations, duration_ms=(t1 - t0) * 1e3,
                queue_depth=len(wave), bucket_occupancy=occupancy, padded_flop_waste=waste,
                buckets=list(buckets), reoptimized=reoptimized,
            )
        return WaveStats(
            wave=self._wave - 1, n_predict=len(predicts), n_observe=len(observes), points_absorbed=absorbed,
            buckets=buckets, migrations=migrations, duration_s=t1 - t0, reoptimized=reoptimized,
        )

    def flush(self) -> int:
        """Materialize the in-flight prediction wave and finish its requests;
        returns how many were finished (0 when none is in flight).  Safe to
        call at any point between waves."""
        fl, self._inflight = self._inflight, None
        if fl is None:
            return 0
        if fl.done is not None:
            fl.done.synchronize()
        t_done = self.clock()
        finished = 0
        for i, reqs in fl.per_problem.items():
            off = fl.offsets[i]
            for r in reqs:
                k = r.x.reshape(-1, fl.d).shape[0]
                mean = fl.host[off:off + k]
                r.result = (mean, fl.host[fl.n_rows + off:fl.n_rows + off + k]) if r.uncertainty else mean
                off += k
                self._finish(r, t_done)
                finished += 1
        return finished

    def run_until_idle(self, max_waves: int = 1000) -> List[WaveStats]:
        """Step until the queue drains (only what is queued on entry and
        between waves), then flush the final wave, so every request queued on
        entry is finished on exit."""
        stats = []
        while self._queue and len(stats) < max_waves:
            stats.append(self.step())
        self.flush()
        return stats

    # -- results / accounting -----------------------------------------------

    def result(self, rid: int):
        """Pop a finished request's result; raises KeyError if unknown or
        still queued.  A request whose wave is dispatched but not fetched is
        flushed first."""
        if rid not in self._done and self._inflight is not None:
            self.flush()
        return self._done.pop(rid).result

    def summary(self) -> Dict[str, float]:
        """Throughput and latency over every finished request.

        Percentiles come from the private registry's request-latency
        histogram (interpolated in a bucket, clamped to the exact observed
        [min, max]): zero requests give 0.0, one request gives its latency
        for every percentile, and p99 >= p50.
        """
        h = self._metrics.histogram("serve.request_latency_ms")
        empty = h.count == 0
        elapsed = max(self.clock() - self._t0, 1e-9)
        return {
            "requests": float(self._served),
            "waves": float(self._wave),
            "req_per_s": self._served / elapsed,
            "p50_ms": 0.0 if empty else h.percentile(50),
            "p99_ms": 0.0 if empty else h.percentile(99),
            "max_ms": 0.0 if empty else h.max,
            "reoptimizations": self._metrics.counter("serve.reoptimizations").value,
        }

    def metrics_snapshot(self) -> dict:
        """The private wave-accounting registry's full snapshot."""
        return self._metrics.snapshot()

    def _finish(self, r: Request, t: float) -> None:
        r.t_done = t
        self._metrics.histogram("serve.request_latency_ms").observe((t - r.t_submit) * 1e3)
        self._metrics.counter("serve.requests").inc()
        self._done[r.rid] = r
        self._served += 1

    def _capacity_map(self) -> Dict[int, int]:
        return {i: cap for cap, idx in self.fleet.bucket_assignment().items() for i in idx}
