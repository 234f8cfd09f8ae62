"""Trace spans for the host dispatch boundaries.

A span wraps a host call in ``torch.profiler.record_function``, so that the
package's stages show as named ranges in a ``torch.profiler`` trace (CPU
ranges, under which the card's kernels of that call are listed).  When
telemetry is disabled (the default) :func:`span` returns one shared no-op
context manager: no allocation and no profiler call.
"""

from __future__ import annotations

import contextlib
import functools

import torch

# not ``from repro_torch.obs import registry``: the package re-exports a
# function of that name, which shadows the submodule attribute
from repro_torch.obs.registry import enabled as _obs_enabled

_NULL = contextlib.nullcontext()


def span(name: str):
    """Context manager: a ``record_function`` range when enabled, a no-op when off."""
    if not _obs_enabled():
        return _NULL
    return torch.profiler.record_function(name)


class Tracer:
    """Span factory with a fixed name prefix.

    >>> tr = Tracer("repro_torch.serve")
    >>> with tr.span("wave"):
    ...     dispatch_wave()
    """

    def __init__(self, prefix: str = "repro_torch") -> None:
        self.prefix = prefix

    def span(self, name: str):
        return span(f"{self.prefix}.{name}")

    def named_scope(self, name: str):
        """A ``record_function`` range whether or not telemetry is on (the
        counterpart of the JAX package's in-trace scope; eager torch has no
        trace, so this is the same range as :meth:`span`, unconditional)."""
        return torch.profiler.record_function(f"{self.prefix}.{name}")

    def annotate(self, name: str):
        """Decorator form of :meth:`span`."""

        def deco(fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)

            return wrapped

        return deco
