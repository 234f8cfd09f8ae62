"""Tiled right-looking Cholesky decomposition (paper Fig. 1) on packed tiles.

The factorization runs on the packed symmetric-lower store of
:mod:`repro_torch.core.tiling` through the level-batched executor: the ASAP
(or wavefront) schedule is compiled into one batched launch per (level, op,
stream chunk), each launch going to the port's POTRF / TRSM / trailing-update
kernels on the card.  ``n_streams`` is the CUDA-stream-pool analogue (``None``
batches whole levels, ``1`` is fully sequential); it sets the batching
granularity, and the launches still run on one CUDA stream.
``monolithic_cholesky`` is the cuSOLVER baseline the paper compares against.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import executor, tiling
from repro_torch.device import resolve_device


def tiled_cholesky(
    packed: torch.Tensor,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    device="cuda",
) -> torch.Tensor:
    """Factor a packed symmetric-lower tile store K -> L (a new tensor).

    packed: (T, m, m) with T = M(M+1)/2 (see tiling.pack_lower).
    """
    return executor.run_cholesky(
        packed, n_streams=n_streams, update_dtype=update_dtype, device=device
    )


def cholesky_dense_via_tiles(
    a: torch.Tensor,
    m: int,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    device="cuda",
) -> torch.Tensor:
    """Dense (n, n) SPD -> dense lower Cholesky factor, via the tiled path."""
    a = torch.as_tensor(a, device=resolve_device(device))
    lpacked = tiled_cholesky(
        tiling.pack_lower(a, m),
        n_streams=n_streams,
        update_dtype=update_dtype,
        device=device,
    )
    return tiling.unpack_lower(lpacked, fill="lower")


def monolithic_cholesky(a: torch.Tensor) -> torch.Tensor:
    """The cuSOLVER-reference analogue: one ``torch.linalg.cholesky`` call."""
    return torch.linalg.cholesky(a)
