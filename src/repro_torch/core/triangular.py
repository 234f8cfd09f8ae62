"""Tiled triangular solves and tiled matmul helpers for the GP pipeline.

Forward substitution   L b = y        (paper: L beta = y)
Backward substitution  L^T a = b      (paper: L^T alpha = beta)
Matrix forward solve   L V = B        (paper: L V = K_{X,X̂}, for uncertainty)

All operate on the packed symmetric-lower tile store for L and tile stacks
for vectors/matrices, driven by the solve DAGs of the scheduler through the
executor (TRSV diagonal solves, GEMV row propagations).  These are the
*staged* entry points; the fused prediction program embeds the same DAGs.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import executor, tiling


@functools.lru_cache(maxsize=None)
def _diag_slots(m_tiles: int) -> np.ndarray:
    """Packed slots of the diagonal tiles (i, i)."""
    return np.array(
        [tiling.packed_index(i, i, m_tiles) for i in range(m_tiles)], np.int64
    )


def forward_substitution(
    lpacked, y_chunks, *, n_streams: Optional[int] = None, device="cuda"
) -> torch.Tensor:
    """Solve L b = y.  lpacked: (T, m, m); y_chunks: (M, m) -> b chunks (M, m)."""
    return executor.run_solve(lpacked, y_chunks, lower=True, n_streams=n_streams, device=device)


def backward_substitution(
    lpacked, b_chunks, *, n_streams: Optional[int] = None, device="cuda"
) -> torch.Tensor:
    """Solve L^T a = b.  Uses tiles (k, i) for k > i: (L^T)_{i,k} = L_{k,i}^T."""
    return executor.run_solve(lpacked, b_chunks, lower=False, n_streams=n_streams, device=device)


def forward_substitution_matrix(
    lpacked, b_tiles, *, n_streams: Optional[int] = None, device="cuda"
) -> torch.Tensor:
    """Solve L V = B for a tiled matrix RHS: (M, Q, m, mq) -> (M, Q, m, mq)."""
    return executor.run_solve(lpacked, b_tiles, lower=True, n_streams=n_streams, device=device)


def backward_substitution_matrix(
    lpacked, b_tiles, *, n_streams: Optional[int] = None, device="cuda"
) -> torch.Tensor:
    """Solve L^T X = B for a tiled matrix RHS."""
    return executor.run_solve(lpacked, b_tiles, lower=False, n_streams=n_streams, device=device)


def tiled_matvec(a_tiles: torch.Tensor, x_chunks: torch.Tensor) -> torch.Tensor:
    """(P, Q, m, mq) tile grid times (Q, mq) chunked vector -> (P, m)."""
    return torch.einsum("pqab,qb->pa", a_tiles, x_chunks)


def tiled_gram(v_tiles: torch.Tensor) -> torch.Tensor:
    """W = V^T V for V tiles (M, Q, m, mq) -> W tiles (Q, Q, mq, mq)."""
    return torch.einsum("ipab,iqac->pqbc", v_tiles, v_tiles)


def packed_matvec(
    lpacked: torch.Tensor, chunks: torch.Tensor, *, transpose: bool = False
) -> torch.Tensor:
    """y = L x (or L^T x) against the packed lower factor; chunks (M, m)."""
    m_tiles = chunks.shape[-2]
    if tiling.num_packed_tiles(m_tiles) != lpacked.shape[-3]:
        raise ValueError(
            f"chunk rows {m_tiles} inconsistent with packed store {tuple(lpacked.shape)}"
        )
    rows, cols = (torch.from_numpy(a) for a in tiling._packed_coords(m_tiles))
    m = lpacked.shape[-1]
    dense = lpacked.new_zeros((m_tiles, m_tiles, m, m))
    dense[rows, cols] = lpacked
    ein = "jiba,jb->ia" if transpose else "ijab,jb->ia"
    return torch.einsum(ein, dense, chunks.to(lpacked.dtype))


def logdet_from_factor(lpacked: torch.Tensor, m_tiles: int, n_valid=None) -> torch.Tensor:
    """log det K = 2 sum_i log diag(L)_i from the packed factor.

    With ``n_valid`` (a scalar here) the diagonal entries at global index
    >= n_valid are masked to 1, so a factor whose padding is not identity
    cannot corrupt the log-determinant.
    """
    slots = torch.from_numpy(_diag_slots(m_tiles)).to(lpacked.device)
    diags = torch.diagonal(lpacked.index_select(-3, slots), dim1=-2, dim2=-1)  # (M, m)
    if n_valid is not None:
        m = lpacked.shape[-1]
        gi = (
            torch.arange(m_tiles, device=lpacked.device)[:, None] * m
            + torch.arange(m, device=lpacked.device)[None, :]
        )
        diags = torch.where(gi < n_valid, diags, torch.ones((), dtype=diags.dtype, device=diags.device))
    return 2.0 * torch.sum(torch.log(diags), dim=(-2, -1))
