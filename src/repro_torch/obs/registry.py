"""Process-local telemetry registry of the port.

Counters, gauges, fixed-bucket histograms and a structured JSON-lines event
log, plus a registry of the package's ``lru_cache``d plan factories, so that
a plan-cache regression shows at run time (:func:`cache_stats`).

**Nothing recorded when off.**  The module-level helpers (:func:`inc`,
:func:`observe`, :func:`event`, ...) check one module-level boolean before
doing any work: no dict lookup, no string formatting, no allocation.  A hot
path that has to *build* an instrument name or an event payload guards it
with ``if obs.enabled():``.  Nothing here reads a device tensor: every value
recorded is a host value (a plan's static digest, a count known on the
host, a host clock), so recording never synchronizes the card's stream.

:class:`Registry` itself is unconditional storage: the serving loop keeps a
private, always-on instance for its own wave accounting
(:meth:`repro_torch.serve.ContinuousBatcher.summary` reads it), while the
module-level registry is the process-wide one behind the flag.  Prometheus
names carry the ``repro_`` prefix, the same names the JAX package exports.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence

# Geometric edges spanning 1e-3 .. 1e5 (µs-to-minutes when observing ms).
DEFAULT_EDGES = tuple(float(10.0 ** (k / 4.0)) for k in range(-12, 21))
# Linear edges for fractions in [0, 1] (occupancy, padded-FLOP waste).
FRACTION_EDGES = tuple(i / 20.0 for i in range(1, 21))
# Power-of-two-ish edges for small integer depths (queues, inflight waves).
COUNT_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
               1024.0, 4096.0)

MAX_EVENTS = 4096  # in-memory ring; the JSONL sink keeps everything


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    ``edges`` are upper bounds; an implicit +inf bucket catches overflow.
    Percentiles interpolate linearly inside the hit bucket, clamped to the
    exact observed [min, max] — so an empty histogram yields NaN, a single
    sample yields that sample for every q, and q -> percentile(q) is
    monotone (the tiny/empty-sample fix the serving summary relies on).
    """

    __slots__ = ("edges", "counts", "sum", "count", "min", "max")

    def __init__(self, edges: Sequence[float] = DEFAULT_EDGES) -> None:
        self.edges = tuple(sorted(float(e) for e in edges))
        if not self.edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        rank = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.edges[i - 1] if i > 0 else self.min
                hi = self.edges[i] if i < len(self.edges) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                return lo + (hi - lo) * frac
            cum += c
        return self.max

    def to_dict(self) -> dict:
        empty = self.count == 0
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
            "min": None if empty else self.min,
            "max": None if empty else self.max,
            "p50": None if empty else self.percentile(50),
            "p99": None if empty else self.percentile(99),
        }


class Registry:
    """One namespace of named instruments + an event ring buffer."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.events: deque = deque(maxlen=MAX_EVENTS)
        self._sink = None

    # -- instruments (get-or-create; first registration wins the edges) ----

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, edges: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                DEFAULT_EDGES if edges is None else edges
            )
        return h

    # -- events -------------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        self.events.append(rec)
        if self._sink is not None:
            self._sink.write(json.dumps(rec, default=str) + "\n")

    def open_sink(self, path: str) -> None:
        self.close_sink()
        self._sink = open(path, "w")

    def close_sink(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.to_dict() for k, h in sorted(self._histograms.items())
            },
            "events": list(self.events),
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), default=str)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, names prefixed ``repro_``."""
        lines = []
        for name, c in sorted(self._counters.items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {_prom_val(c.value)}")
        for name, g in sorted(self._gauges.items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_prom_val(g.value)}")
        for name, h in sorted(self._histograms.items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} histogram")
            cum = 0
            for edge, cnt in zip(h.edges, h.counts):
                cum += cnt
                lines.append(f'{pn}_bucket{{le="{edge:g}"}} {cum}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{pn}_sum {_prom_val(h.sum)}")
            lines.append(f"{pn}_count {h.count}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()
        self.events.clear()
        self.close_sink()


def _prom_name(name: str) -> str:
    return "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_val(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    return f"{int(v)}" if float(v).is_integer() else f"{v:g}"


# ---------------------------------------------------------------------------
# The process-global registry, gated by the module-level enabled flag.
# ---------------------------------------------------------------------------

_enabled = False
_global = Registry()
_caches: Dict[str, Callable] = {}


def registry() -> Registry:
    """The process-global :class:`Registry` (read it even when disabled)."""
    return _global


def enabled() -> bool:
    return _enabled


def enable(jsonl_path: Optional[str] = None) -> None:
    """Turn telemetry on; with ``jsonl_path``, stream every event to a
    JSON-lines file as well as the in-memory ring buffer."""
    global _enabled
    _enabled = True
    if jsonl_path:
        _global.open_sink(jsonl_path)


def disable() -> None:
    """Turn telemetry off (and close any JSONL sink)."""
    global _enabled
    _enabled = False
    _global.close_sink()


def reset() -> None:
    """Drop every instrument and event; the enabled flag is untouched."""
    _global.clear()


def inc(name: str, n: float = 1.0) -> None:
    if _enabled:
        _global.counter(name).inc(n)


def set_gauge(name: str, v: float) -> None:
    if _enabled:
        _global.gauge(name).set(v)


def observe(name: str, v: float, edges: Optional[Sequence[float]] = None) -> None:
    if _enabled:
        _global.histogram(name, edges).observe(v)


def event(kind: str, **fields) -> None:
    if _enabled:
        _global.event(kind, **fields)


def health_event(name: str, **fields) -> None:
    """Count + log one factorization-health incident (refactorize fallback,
    NaN-guard trip, jitter retry) under ``health.<name>``."""
    if _enabled:
        _global.counter(f"health.{name}").inc()
        _global.event(f"health.{name}", **fields)


def snapshot() -> dict:
    return _global.snapshot()


def to_json() -> str:
    return _global.to_json()


def to_prometheus() -> str:
    return _global.to_prometheus()


# ---------------------------------------------------------------------------
# lru-cache registry: executor/predict/update register their cached plan and
# jit factories at import time; cache_stats() snapshots hits/misses/sizes.
# ---------------------------------------------------------------------------


def register_cache(name: str, fn: Callable) -> None:
    """Register an ``functools.lru_cache``d factory for :func:`cache_stats`.

    Registration is unconditional (import-time, not flag-gated) — reading a
    ``cache_info()`` later is free until someone asks for the snapshot.
    """
    _caches[name] = fn


def cache_stats() -> Dict[str, dict]:
    """``{name: {hits, misses, size}}`` across every registered lru cache."""
    out = {}
    for name, fn in sorted(_caches.items()):
        info = fn.cache_info()
        out[name] = {
            "hits": info.hits,
            "misses": info.misses,
            "size": info.currsize,
        }
    return out
