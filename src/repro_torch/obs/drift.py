"""NLML-trend drift monitor.

A streaming GP's hyperparameters go stale when the data distribution
drifts: the warm append keeps the factor exact for the grown data, but the
NLML per point creeps up because the kernel no longer fits.
:class:`DriftMonitor` watches a scalar NLML-per-point stream with a double
EWMA, a smoothed *level* and a smoothed *trend* (the EWMA of the
innovations), and fires when the trend exceeds a threshold: a persistent
upward slope, not one noisy wave.

The serving loop (:class:`repro_torch.serve.ContinuousBatcher`) consults it
after each wave that absorbed observations and, on a trigger, runs a
re-optimize at the end of the wave.  The monitor is pure Python and works on
any NLML stream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class DriftMonitor:
    """EWMA level/trend monitor over a per-point NLML stream.

    ``observe(nlml)`` returns True when a re-optimize should be scheduled:
    the smoothed upward trend exceeded ``threshold`` (nats/point per
    observation), at least ``warmup`` observations have been seen, and at
    least ``cooldown`` observations have passed since the last trigger.
    After the triggered re-optimize completes, call :meth:`reset` — the
    new hyperparameters define a new NLML level and the old trend state
    is meaningless against it.
    """

    alpha: float = 0.3        # EWMA smoothing for both level and trend
    threshold: float = 0.05   # smoothed slope that counts as drift
    warmup: int = 3           # observations before the trend is trusted
    cooldown: int = 8         # min observations between triggers

    triggers: int = dataclasses.field(default=0, init=False)
    _level: Optional[float] = dataclasses.field(default=None, init=False)
    _trend: float = dataclasses.field(default=0.0, init=False)
    _count: int = dataclasses.field(default=0, init=False)
    _since: int = dataclasses.field(default=1 << 30, init=False)

    def observe(self, nlml: float) -> bool:
        v = float(nlml)
        if not math.isfinite(v):
            return False  # a NaN wave is a health event, not a trend sample
        self._count += 1
        self._since += 1
        if self._level is None:
            self._level = v
            return False
        delta = v - self._level  # innovation vs the smoothed level
        self._level += self.alpha * delta
        self._trend = (1.0 - self.alpha) * self._trend + self.alpha * delta
        if self._count <= self.warmup or self._since <= self.cooldown:
            return False
        if self._trend > self.threshold:
            self.triggers += 1
            self._since = 0
            self._trend = 0.0
            return True
        return False

    @property
    def level(self) -> Optional[float]:
        """The current smoothed NLML level (None before the first sample)."""
        return self._level

    @property
    def trend(self) -> float:
        """The current smoothed slope (nats/point per observation)."""
        return self._trend

    def reset(self) -> None:
        """Forget level/trend (call after a re-optimize lands); the trigger
        count survives — it is the monitor's lifetime statistic — and so
        does the observations-since-trigger clock, so ``cooldown`` keeps
        gating re-triggers across the reset (warmup re-applies too: the new
        level needs fresh samples before its trend is trusted)."""
        self._level = None
        self._trend = 0.0
        self._count = 0
