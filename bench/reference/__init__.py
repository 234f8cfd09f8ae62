"""The plain reference that decides ``correct``, one module a call (``bench/reference/<call>.py``).

A module gives ``expected(pool, tests, cfg, mix, keys)``: what the call
should return on each (training dataset, test set) pair in ``keys``,
computed in the dtype of the tensors it is given; ``gaps(cfg, mix, outputs, expected)``: the numbers
compared, each a gap between the program's outputs and the expected ones;
and ``as_outputs(expected, keys)``: expected values laid out as a request's
outputs, so that the reference computed in a lower precision can stand in
the program's place (the control).  Nothing here imports the program.
"""

from __future__ import annotations

import torch

INF = 1e30  # a reading that failed outright (misshapen or non-finite output)


def rel_max_gap(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """max |got - want| / scale, in float64; a misshapen or non-finite output reads inf."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return INF
    gap = (got.double() - want.double()).abs().max()
    return float(gap) / scale if bool(torch.isfinite(gap)) else INF


def rel_rms_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """rms(got - want) / rms(want), in float64; a misshapen or non-finite output reads INF."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return INF
    w = want.double()
    gap = ((got.double() - w).pow(2).mean() / w.pow(2).mean()).sqrt()
    return float(gap) if bool(torch.isfinite(gap)) else INF
