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
from repro_torch.kernels import ops


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
    """((B,) P, Q, m, mq) tile grid times ((B,) Q, mq) chunked vector -> ((B,) P, m).

    B problems go through ``ops.tile_gemv`` (batch-invariant, as
    :func:`executor.tile_matvec`).
    """
    if a_tiles.ndim == 5:
        return ops.tile_gemv(a_tiles, x_chunks[:, None].expand(-1, a_tiles.shape[1], -1, -1))
    return torch.einsum("pqab,qb->pa", a_tiles, x_chunks)


def tiled_gram(v_tiles: torch.Tensor) -> torch.Tensor:
    """W = V^T V for V tiles ((B,) M, Q, m, mq) -> W tiles ((B,) Q, Q, mq, mq).

    B problems' grams are taken as :func:`executor.matrix_product` takes them.
    """
    return executor.matrix_product("ipab,iqac->pqbc", v_tiles, v_tiles, v_tiles.ndim == 5)


def packed_matvec(
    lpacked: torch.Tensor, chunks: torch.Tensor, *, transpose: bool = False
) -> torch.Tensor:
    """y = L x (or L^T x) against the packed lower factor; chunks ((B,) M, m), B the optional problem axis."""
    m_tiles = chunks.shape[-2]
    if tiling.num_packed_tiles(m_tiles) != lpacked.shape[-3]:
        raise ValueError(
            f"chunk rows {m_tiles} inconsistent with packed store {tuple(lpacked.shape)}"
        )
    rows, cols = (torch.from_numpy(a).to(lpacked.device) for a in tiling._packed_coords(m_tiles))
    m = lpacked.shape[-1]
    lead = lpacked.shape[:-3]
    dense = lpacked.new_zeros(lead + (m_tiles * m_tiles, m, m))
    dense.index_copy_(-3, rows * m_tiles + cols, lpacked)
    dense = dense.reshape(lead + (m_tiles, m_tiles, m, m))
    chunks = chunks.to(lpacked.dtype)
    if lead:  # B problems through ops.tile_gemv (batch-invariant, as executor.tile_matvec)
        tiles = dense.permute(0, 2, 1, 4, 3) if transpose else dense
        return ops.tile_gemv(tiles, chunks[:, None].expand(-1, m_tiles, -1, -1))
    return torch.einsum("jiba,jb->ia" if transpose else "ijab,jb->ia", dense, chunks)


def problem_sums(x: torch.Tensor, ndim: int = 2) -> torch.Tensor:
    """The sum over the trailing ``ndim`` dims, one problem (leading index) at a time.

    A batched reduction on the card splits its work by the number of
    problems, so a problem's sum would depend on how many share the call
    (a sharded fleet's NLMLs against the whole fleet's); each problem's own
    reduction sees the same shape whatever B is.
    """
    if x.ndim == ndim:
        return torch.sum(x)
    flat = x.reshape((-1,) + x.shape[-ndim:])
    if flat.shape[0] == 0:
        return x.new_zeros(x.shape[:-ndim])
    return torch.stack([torch.sum(p) for p in flat.unbind(0)]).reshape(x.shape[:-ndim])


def logdet_from_factor(lpacked: torch.Tensor, m_tiles: int, n_valid=None) -> torch.Tensor:
    """log det K = 2 sum_i log diag(L)_i from the packed factor.

    With ``n_valid`` the diagonal entries at global index >= n_valid are
    masked to 1, so a factor whose padding is not identity cannot corrupt
    the log-determinant.  A batched factor (B, T, m, m) returns the B
    log-determinants, and ``n_valid`` may then be (B,) per-problem frontiers.
    """
    slots = torch.from_numpy(_diag_slots(m_tiles)).to(lpacked.device)
    diags = torch.diagonal(lpacked.index_select(-3, slots), dim1=-2, dim2=-1)  # (M, m)
    if n_valid is not None:
        m = lpacked.shape[-1]
        gi = (
            torch.arange(m_tiles, device=lpacked.device)[:, None] * m
            + torch.arange(m, device=lpacked.device)[None, :]
        )
        nv = torch.as_tensor(n_valid, device=lpacked.device)
        if nv.ndim > 0:  # per-problem (B,)
            nv = nv[:, None, None]
        diags = torch.where(gi < nv, diags, torch.ones((), dtype=diags.dtype, device=diags.device))
    return 2.0 * problem_sums(torch.log(diags))
