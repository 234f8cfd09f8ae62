"""repro_torch.obs: telemetry that records nothing when off.

A process-local metrics registry (counters, gauges, fixed-bucket histograms,
JSON-lines events), ``torch.profiler`` ranges at the host dispatch
boundaries, a snapshot of the plan caches' statistics, and the NLML-trend
drift monitor.  A leaf package: it imports nothing of ``repro_torch.core``
(which imports it), so the instrumentation threads through every layer.

    import repro_torch.obs as obs

    obs.enable("metrics.jsonl")      # flip the one global flag
    ...                              # run the instrumented package
    print(obs.to_prometheus())       # or obs.to_json() / obs.snapshot()
    print(obs.cache_stats())         # plan-cache hits and misses
    obs.disable()

Disabled (the default), every helper returns after one module-level boolean
check, and the instrumented paths compute bit for bit what they compute
without it.
"""

from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.registry import (
    COUNT_EDGES,
    DEFAULT_EDGES,
    FRACTION_EDGES,
    MAX_EVENTS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    cache_stats,
    disable,
    enable,
    enabled,
    event,
    health_event,
    inc,
    observe,
    register_cache,
    registry,
    reset,
    set_gauge,
    snapshot,
    to_json,
    to_prometheus,
)
from repro_torch.obs.tracer import Tracer, span

__all__ = [
    "COUNT_EDGES",
    "DEFAULT_EDGES",
    "FRACTION_EDGES",
    "Counter",
    "DriftMonitor",
    "Gauge",
    "Histogram",
    "MAX_EVENTS",
    "Registry",
    "Tracer",
    "cache_stats",
    "disable",
    "enable",
    "enabled",
    "event",
    "health_event",
    "inc",
    "observe",
    "register_cache",
    "registry",
    "reset",
    "set_gauge",
    "snapshot",
    "span",
    "to_json",
    "to_prometheus",
]
