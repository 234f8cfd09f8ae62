"""Tile layouts for the tiled GP pipeline (PyTorch port of ``repro.core.tiling``).

Two layouts are used:

* **Dense tile grid** ``(M_rows, M_cols, m, m)`` for rectangular operands
  (cross covariance, solve workspaces).
* **Packed symmetric-lower store** ``(T, m, m)`` with ``T = M (M+1) / 2``:
  only the lower tiles of a symmetric matrix, packed column by column.

Every tensor helper takes an optional leading problem-batch axis B (the
fleets: B independent problems of one tile geometry).

Packing order (column-major over tile columns):

    col J occupies flat slots  off(J) .. off(J) + (M - J - 1)
    off(J) = J*M - J*(J-1)//2
    tile (I, J) with I >= J lives at  off(J) + (I - J)

The index helpers are plain Python/numpy and device-free (the maps of the
streaming updates, ``grow``/``replace_row``/``shrink``, are lru-cached int64
arrays); the tensor helpers keep the device and dtype of their input
(``dtype=`` casts).
"""

from __future__ import annotations

import functools
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


def column_slice(j: int, m_tiles: int) -> Tuple[int, int]:
    """(start, stop) flat range of packed column j (diagonal tile first)."""
    off = j * m_tiles - (j * (j - 1)) // 2
    return off, off + (m_tiles - j)


def pad_amount(n: int, m: int) -> int:
    """Padding needed to round n up to a multiple of the tile size m."""
    return (-n) % m


def pad_features(x: torch.Tensor, m: int, *, dtype=None) -> torch.Tensor:
    """(n, D) -> (M, m, D) or (B, n, D) -> (B, M, m, D) zero-padded chunks.

    The problem-batch axis B is optional and kept; ``dtype=None`` keeps the dtype.
    """
    if dtype is not None:
        x = x.to(dtype)
    pad = pad_amount(x.shape[-2], m)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.reshape(x.shape[:-2] + (-1, m, x.shape[-1]))


def pad_vector(y: torch.Tensor, m: int, *, dtype=None) -> torch.Tensor:
    """(n,) -> (M, m) or (B, n) -> (B, M, m) zero-padded chunks."""
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
    """Packed (..., T, m, m) -> dense (..., n, n); leading batch axes are kept.

    fill: 'lower'      — upper tiles zero (Cholesky factor output)
          'symmetric'  — upper tiles mirrored (covariance matrix)
    """
    t, m = packed.shape[-3], packed.shape[-1]
    m_tiles = int((math.isqrt(8 * t + 1) - 1) // 2)
    if num_packed_tiles(m_tiles) != t:
        raise ValueError(f"{t} is not a triangular tile count")
    if fill not in ("lower", "symmetric"):
        raise ValueError(f"unknown fill: {fill}")
    lead = packed.shape[:-3]
    rows, cols = (torch.from_numpy(a).to(packed.device) for a in _packed_coords(m_tiles))
    dense = packed.new_zeros(lead + (m_tiles * m_tiles, m, m))
    dense.index_copy_(-3, rows * m_tiles + cols, packed)
    if fill == "symmetric":
        off = rows != cols
        dense.index_copy_(-3, cols[off] * m_tiles + rows[off], packed[..., off, :, :].transpose(-1, -2))
    full = untile_dense(dense.reshape(lead + (m_tiles, m_tiles, m, m)))
    if fill == "lower":
        full = torch.tril(full)  # zero the upper triangle inside diagonal tiles
    return full


# ---------------------------------------------------------------------------
# Index maps of the streaming updates (lru-cached numpy gather/scatter maps).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def grow_packed_indices(m_tiles_old: int) -> np.ndarray:
    """Gather indices that append one tile-row to a packed store.

    Let ``cat = concat(old_packed (T_old), row_buffer (M_old + 1))`` where
    the row buffer holds the new row's tiles (R, 0..R-1) plus the corner
    (R, R), R = M_old.  Then ``cat[grow_packed_indices(M_old)]`` is the
    packed store of the grown (M_old + 1)-tile factor: the column-major
    packing interleaves the new row's tile at the end of every column.
    """
    m_old, m_new = m_tiles_old, m_tiles_old + 1
    t_old = num_packed_tiles(m_old)
    idx = np.empty(num_packed_tiles(m_new), np.int64)
    for j in range(m_new):
        for i in range(j, m_new):
            idx[packed_index(i, j, m_new)] = (
                t_old + j if i == m_old else packed_index(i, j, m_old)
            )
    return idx


@functools.lru_cache(maxsize=None)
def replace_row_indices(row: int, m_tiles: int) -> np.ndarray:
    """Packed slots of tile-row ``row``: (row, 0..row), corner last.

    Scattering a row buffer (row + 1 tiles, corner last) into these slots
    overwrites one tile-row of an existing packed store: the append path
    that refills a partially padded trailing tile.
    """
    return np.array([packed_index(row, j, m_tiles) for j in range(row + 1)], np.int64)


def replace_last_row_indices(m_tiles: int) -> np.ndarray:
    """Packed slots of the last tile-row (R, 0..R), R = m_tiles - 1."""
    return replace_row_indices(m_tiles - 1, m_tiles)


@functools.lru_cache(maxsize=None)
def shrink_packed_indices(m_tiles_old: int) -> Tuple[np.ndarray, np.ndarray]:
    """(trailing, evicted) gather indices that drop the leading tile-column.

    ``old_packed[trailing]`` is the packed store of the trailing
    (M_old - 1)-tile block (tiles (i, j) with i, j >= 1);
    ``old_packed[evicted]`` is the evicted column's sub-diagonal panel
    (tiles (1.., 0)): the rank-m carry W of the eviction update.
    """
    m_old, m_new = m_tiles_old, m_tiles_old - 1
    trailing = np.empty(num_packed_tiles(m_new), np.int64)
    for j in range(m_new):
        for i in range(j, m_new):
            trailing[packed_index(i, j, m_new)] = packed_index(i + 1, j + 1, m_old)
    evicted = np.array([packed_index(i, 0, m_old) for i in range(1, m_old)], np.int64)
    return trailing, evicted


# ---------------------------------------------------------------------------
# Ragged fleets: re-embedding a factor into a larger geometry, and buckets.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def embed_packed_indices(m_tiles_old: int, m_tiles_new: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather map embedding a packed factor into a larger tile geometry.

    Padding is identity by construction, so the factor of the same problem
    in a larger store is exactly ``blockdiag(L_old, I)``: growing a factor
    from ``m_tiles_old`` to ``m_tiles_new`` tile-rows is a gather with no
    arithmetic.  Returns ``(src, kind)`` of length
    ``num_packed_tiles(m_tiles_new)``: kind 0 copies ``old_packed[src]``,
    1 is an identity tile, 2 a zero tile.  A problem of a ragged fleet that
    crosses a bucket boundary re-embeds its live factor this way instead of
    refactorizing.
    """
    if m_tiles_new < m_tiles_old:
        raise ValueError(f"cannot shrink: {m_tiles_old} -> {m_tiles_new}")
    t_new = num_packed_tiles(m_tiles_new)
    src = np.zeros(t_new, np.int64)
    kind = np.full(t_new, 2, np.int64)
    for j in range(m_tiles_new):
        for i in range(j, m_tiles_new):
            slot = packed_index(i, j, m_tiles_new)
            if i < m_tiles_old and j < m_tiles_old:
                src[slot] = packed_index(i, j, m_tiles_old)
                kind[slot] = 0
            elif i == j:
                kind[slot] = 1
    return src, kind


def embed_packed(packed: torch.Tensor, m_tiles_old: int, m_tiles_new: int) -> torch.Tensor:
    """Embed packed factor tiles (..., T_old, m, m) into (..., T_new, m, m)."""
    src, kind = embed_packed_indices(m_tiles_old, m_tiles_new)
    dev, m = packed.device, packed.shape[-1]
    tiles = packed.index_select(-3, torch.from_numpy(src).to(dev))
    kindb = torch.from_numpy(kind).to(dev)[:, None, None]
    eye = torch.eye(m, dtype=packed.dtype, device=dev)
    return torch.where(kindb == 0, tiles, torch.where(kindb == 1, eye, torch.zeros((), dtype=packed.dtype, device=dev)))


DEFAULT_BUCKETS = "pow2"


def bucket_boundaries(m_tiles_max: int, boundaries=DEFAULT_BUCKETS) -> Tuple[int, ...]:
    """A bucket-boundary spec as a sorted tuple of tile-count caps.

    ``"pow2"``: powers of two up to (and covering) ``m_tiles_max``; an int
    k: k geometrically spaced caps from 1 to ``m_tiles_max``; an iterable:
    explicit caps, extended with ``m_tiles_max`` if they do not cover it.
    Every spec covers ``m_tiles_max``.
    """
    m_tiles_max = max(int(m_tiles_max), 1)
    if boundaries == "pow2":
        caps = []
        c = 1
        while c < m_tiles_max:
            caps.append(c)
            c *= 2
        caps.append(c)
        return tuple(caps)
    if isinstance(boundaries, int):
        k = max(boundaries, 1)
        caps = sorted(
            {
                max(1, int(round(m_tiles_max ** (i / (k - 1)))) if k > 1 else m_tiles_max)
                for i in range(k)
            }
        )
        if caps[-1] != m_tiles_max:
            caps[-1] = m_tiles_max
        return tuple(dict.fromkeys(caps))
    caps = sorted({int(c) for c in boundaries if int(c) >= 1})
    if not caps or caps[-1] < m_tiles_max:
        caps.append(m_tiles_max)
    return tuple(caps)


def bucket_problems(ns, m: int, boundaries=DEFAULT_BUCKETS):
    """Assign ragged problems to tile-geometry buckets.

    ``ns`` are the per-problem observation counts, ``m`` the tile size.  A
    problem needs ``ceil(n / m)`` tile-rows, rounded up to the smallest cap
    of :func:`bucket_boundaries` that fits, so problems of nearby sizes share
    one bucket (one program, one plan) and the per-problem ``n_valid`` mask
    absorbs the padding.  Returns ``{cap_tiles: [problem indices]}``, caps
    ascending, submission order kept within a bucket.
    """
    ns = [int(n) for n in ns]
    if any(n < 1 for n in ns):
        raise ValueError(f"every problem needs at least one observation: {ns}")
    need = [max(-(-n // m), 1) for n in ns]
    caps = bucket_boundaries(max(need), boundaries)
    out: dict = {}
    for i, nd in enumerate(need):
        cap = next(c for c in caps if c >= nd)
        out.setdefault(cap, []).append(i)
    return dict(sorted(out.items()))


def packed_bytes(m_tiles: int, m: int, dtype=torch.float32) -> int:
    """Bytes of a packed lower store of M tiles of m x m."""
    return num_packed_tiles(m_tiles) * m * m * torch.empty((), dtype=dtype).element_size()


def dense_bytes(n: int, dtype=torch.float32) -> int:
    """Bytes of a dense n x n matrix."""
    return n * n * torch.empty((), dtype=dtype).element_size()
