"""Tile layouts for the tiled GP pipeline (PyTorch port of ``repro.core.tiling``).

Two layouts are used:

* **Dense tile grid** ``(M_rows, M_cols, m, m)`` for rectangular operands
  (cross covariance, solve workspaces).
* **Packed symmetric-lower store** ``(T, m, m)`` with ``T = M (M+1) / 2``:
  only the lower tiles of a symmetric matrix, packed column by column.

Packing order (column-major over tile columns):

    col J occupies flat slots  off(J) .. off(J) + (M - J - 1)
    off(J) = J*M - J*(J-1)//2
    tile (I, J) with I >= J lives at  off(J) + (I - J)

The index helpers are plain Python/numpy and device-free; the tensor
helpers keep the device and dtype of their input (``dtype=`` casts).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def num_packed_tiles(m_tiles: int) -> int:
    return m_tiles * (m_tiles + 1) // 2


def packed_index(i: int, j: int, m_tiles: int) -> int:
    """Flat slot of lower tile (i, j), i >= j, in the packed store."""
    if i < j:
        raise ValueError(f"packed_index requires i >= j, got ({i}, {j})")
    off = j * m_tiles - (j * (j - 1)) // 2
    return off + (i - j)


def pad_amount(n: int, m: int) -> int:
    """Padding needed to round n up to a multiple of the tile size m."""
    return (-n) % m


def pad_features(x: torch.Tensor, m: int, *, dtype=None) -> torch.Tensor:
    """(n, D) -> (M, m, D) zero-padded chunks; ``dtype=None`` keeps the dtype."""
    if dtype is not None:
        x = x.to(dtype)
    pad = pad_amount(x.shape[-2], m)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.reshape(x.shape[:-2] + (-1, m, x.shape[-1]))


def pad_vector(y: torch.Tensor, m: int, *, dtype=None) -> torch.Tensor:
    """(n,) -> (M, m) zero-padded chunks."""
    if dtype is not None:
        y = y.to(dtype)
    pad = pad_amount(y.shape[-1], m)
    if pad:
        y = torch.nn.functional.pad(y, (0, pad))
    return y.reshape(y.shape[:-1] + (-1, m))


def tile_dense(a: torch.Tensor, m: int) -> torch.Tensor:
    """(R, C) -> (R/m, C/m, m, m) tile grid.  R, C must divide by m."""
    r, c = a.shape
    if r % m or c % m:
        raise ValueError(f"shape {tuple(a.shape)} not divisible by tile size {m}")
    return a.reshape(r // m, m, c // m, m).permute(0, 2, 1, 3)


def untile_dense(tiles: torch.Tensor) -> torch.Tensor:
    """(Mr, Mc, m, mc) -> (Mr*m, Mc*mc); leading batch axes are preserved."""
    mr, mc, m, mc2 = tiles.shape[-4:]
    return tiles.transpose(-3, -2).reshape(tiles.shape[:-4] + (mr * m, mc * mc2))


def tile_vector(v: torch.Tensor, m: int) -> torch.Tensor:
    """(n,) -> (M, m) stack of vector chunks."""
    if v.shape[0] % m:
        raise ValueError(f"length {v.shape[0]} not divisible by {m}")
    return v.reshape(-1, m)


def untile_vector(chunks: torch.Tensor) -> torch.Tensor:
    return chunks.reshape(-1)


def _packed_coords(m_tiles: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col tile indices of every packed slot, as numpy int arrays."""
    rows, cols = [], []
    for j in range(m_tiles):
        for i in range(j, m_tiles):
            rows.append(i)
            cols.append(j)
    return np.asarray(rows, np.int64), np.asarray(cols, np.int64)


def pack_lower(a: torch.Tensor, m: int) -> torch.Tensor:
    """Dense symmetric (n, n) -> packed lower tile store (T, m, m)."""
    tiles = tile_dense(a, m)
    rows, cols = _packed_coords(tiles.shape[0])
    return tiles[torch.from_numpy(rows), torch.from_numpy(cols)]


def unpack_lower(packed: torch.Tensor, *, fill: str = "lower") -> torch.Tensor:
    """Packed (T, m, m) -> dense (n, n).

    fill: 'lower'      — upper tiles zero (Cholesky factor output)
          'symmetric'  — upper tiles mirrored (covariance matrix)
    """
    t, m, _ = packed.shape
    m_tiles = int((math.isqrt(8 * t + 1) - 1) // 2)
    if num_packed_tiles(m_tiles) != t:
        raise ValueError(f"{t} is not a triangular tile count")
    if fill not in ("lower", "symmetric"):
        raise ValueError(f"unknown fill: {fill}")
    rows, cols = (torch.from_numpy(a) for a in _packed_coords(m_tiles))
    dense = packed.new_zeros((m_tiles, m_tiles, m, m))
    dense[rows, cols] = packed
    if fill == "symmetric":
        off = rows != cols
        dense[cols[off], rows[off]] = packed[off].transpose(-1, -2)
    full = untile_dense(dense)
    if fill == "lower":
        full = torch.tril(full)  # zero the upper triangle inside diagonal tiles
    return full
