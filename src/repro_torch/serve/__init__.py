"""Continuous-batching GP serving on the port.

Requests against many independent, differently sized GPs are drained in
waves, each run through :class:`repro_torch.core.gp.GPFleet`'s bucketed
ragged programs (one batched call per occupied bucket, per-problem
frontiers masked), with the buckets re-formed between waves as
observations land and problems migrate across geometry boundaries.
"""

from repro_torch.serve.loop import ContinuousBatcher, Request, WaveStats

__all__ = ["ContinuousBatcher", "Request", "WaveStats"]
