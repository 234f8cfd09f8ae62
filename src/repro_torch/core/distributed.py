"""Distributed tiled GP: the block-cyclic Cholesky and solves on ``torch.distributed``.

The paper's stated future work, "extend the library to distributed
multi-GPU environments", as the JAX package builds it (DESIGN.md §6), in
the port's SPMD form: one process a rank, every rank calls the same
function with the same replicated inputs, and each computes only what it
owns.  The mesh is a ``DeviceMesh`` with named dims; the collectives are
:func:`repro_torch.dist.collectives.psum` and ``gather_axes`` over the
groups of its ``row_axes`` and ``col_axes``.

Layout (ScaLAPACK-style 2-D block-cyclic):

    process grid (P, Q) = (prod(row_axes), prod(col_axes)) over the mesh
    tile (I, J) lives on process (I mod P, J mod Q), local slot (I//P, J//Q)
    local store: (Mp, Mq, m, m) with Mp = M/P, Mq = M/Q

Cyclic (not blocked) distribution keeps the trailing update balanced as
the factorization shrinks.  Each step J:

  1. column broadcast: psum-mask of column J's active tiles over ``col_axes``;
  2. panel factor:     POTRF of the diagonal tile on every rank (redundant,
                       m³); TRSM split Q ways over the process columns,
                       then gathered back;
  3. panel gather:     the solved panel to every rank (``row_axes`` gather);
  4. trailing update:  TRAIL on the rank's owned tiles (I, K) with
                       I >= K > J, one launch.

Each rank's tile math runs through :mod:`repro_torch.kernels.ops`, so on the
card every rank launches the port's POTRF, TRSM, TRAIL and cov_tiles
kernels (the local assembly, the variance right-hand sides and the mean's
cross tiles); the forward and backward solves and the variance solve's
diagonal-tile solves are plain torch, as on the single-GP path.
``update_dtype=torch.bfloat16`` sends the panel in bf16 and runs the
trailing products in it, with the diagonal tile in full precision (the
reference's mixed-precision mode; the stored factor column is the panel's).

Eager torch has no trace: both ``unroll`` values take the statically
shrinking active slices that the reference's ``unroll=True`` takes (ROADMAP
§3.6).  The factor a call returns stays rank-local (:func:`local_block` and
:func:`collect_blocks` move between it and the global cyclic store); a
prediction is replicated on every rank.  The assembly is SE's, as the
reference's.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import kernels_math as km
from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops

_SE = km.SQUARED_EXPONENTIAL  # the reference assembles SE only


def grid_shape(mesh, row_axes=("data",), col_axes=("model",)) -> Tuple[int, int]:
    return coll.axes_size(mesh, row_axes), coll.axes_size(mesh, col_axes)


def _check_grid(mesh, m_tiles: int, row_axes, col_axes, where: str) -> Tuple[int, int]:
    coll.check_mesh(mesh, where)
    if mesh is None:
        raise TypeError(f"{where} needs a mesh")
    p, q = grid_shape(mesh, row_axes, col_axes)
    if m_tiles % p or m_tiles % q:
        raise ValueError(f"m_tiles={m_tiles} must divide grid {(p, q)}")
    return p, q


def _owned(mesh, row_axes, col_axes, mp: int, mq: int, p: int, q: int):
    """(global rows of the local row slots, global cols of the local col slots) as int arrays."""
    pr = coll.linear_index(mesh, row_axes)
    pc = coll.linear_index(mesh, col_axes)
    return np.arange(mp) * p + pr, np.arange(mq) * q + pc


def _panel_from_gather(gathered: torch.Tensor) -> torch.Tensor:
    """(P, Na, m, m) row-gathered column -> (P * Na, m, m), global row (ip0 + t) * P + r at t * P + r."""
    return gathered.transpose(0, 1).reshape((-1,) + tuple(gathered.shape[2:]))


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _chol_step(j: int, local: torch.Tensor, *, mesh, m_tiles: int, row_axes, col_axes, p: int, q: int,
               update_dtype=None) -> None:
    """One right-looking factorization step, in place on the local store."""
    mp, mq, m, _ = local.shape
    dev = local.device
    glob_i, glob_k = _owned(mesh, row_axes, col_axes, mp, mq, p, q)
    pr, pc = coll.linear_index(mesh, row_axes), coll.linear_index(mesh, col_axes)
    ip0 = j // p  # the first local row slot that holds a row >= j on some rank of the process column
    base = ip0 * p
    jq, owner_q = j // q, j % q
    comm_dtype = update_dtype if update_dtype is not None else local.dtype

    # 1. broadcast the active rows of column j over the process columns (psum-mask)
    col = local[ip0:, jq] if pc == owner_q else torch.zeros_like(local[ip0:, 0])
    col = coll.psum(col, mesh, col_axes)                                    # (Na, m, m)
    n_act = col.shape[0]

    # 2. the diagonal tile in full precision; POTRF on every rank; the panel solve split Q ways
    drow = col[0] if pr == j % p else torch.zeros_like(col[0])
    ljj = ops.potrf(coll.psum(drow, mesh, row_axes)[None])[0]
    if n_act >= q:
        split = -(-n_act // q)
        pad = split * q - n_act
        padded = torch.cat([col, col[:pad]]) if pad else col
        mine = padded[pc * split:(pc + 1) * split]
        solved = ops.trsm(ljj.expand_as(mine).contiguous(), mine.contiguous()).to(comm_dtype)
        solved = coll.gather_axes(solved, mesh, col_axes).reshape((split * q, m, m))[:n_act]
    else:
        solved = ops.trsm(ljj.expand_as(col).contiguous(), col.contiguous()).to(comm_dtype)
    panel = _panel_from_gather(coll.gather_axes(solved, mesh, row_axes))  # rows base ... of column j
    panel[j - base] = ljj.to(comm_dtype)

    # 3. the trailing update on the owned active tiles I >= K > j, one launch
    ii, kk = np.nonzero((glob_i[:, None] > j) & (glob_k[None, :] > j) & (glob_i[:, None] >= glob_k[None, :]))
    if len(ii):
        ti, tk = _idx(ii, dev), _idx(kk, dev)
        a = panel.index_select(0, _idx(glob_i[ii] - base, dev))
        b = panel.index_select(0, _idx(glob_k[kk] - base, dev))
        local[ti, tk] = ops.trail(local[ti, tk].contiguous(), a, b, update_dtype)

    # 4. write the factored column back on its process column
    if pc == owner_q:
        rows = np.nonzero(glob_i >= j)[0]
        if len(rows):
            local[_idx(rows, dev), jq] = panel.index_select(0, _idx(glob_i[rows] - base, dev)).to(local.dtype)


def _cholesky(local: torch.Tensor, *, mesh, m_tiles: int, row_axes, col_axes, p: int, q: int,
              update_dtype=None) -> torch.Tensor:
    local = local.clone()
    for j in range(m_tiles):
        _chol_step(j, local, mesh=mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes, p=p, q=q,
                   update_dtype=update_dtype)
    return local


def distributed_cholesky_fn(mesh, *, m_tiles: int, row_axes: Tuple[str, ...] = ("data",),
                            col_axes: Tuple[str, ...] = ("model",), unroll: bool = False, update_dtype=None):
    """``fn(local) -> factored local``: the block-cyclic Cholesky of a rank's (Mp, Mq, m, m) block.

    Every rank of the mesh calls ``fn`` with its own block
    (:func:`local_block` of the global cyclic store); the result is the
    rank's block of the lower factor (strictly upper tiles as given).
    ``unroll`` is accepted for parity: both values run the shrinking slices.
    """
    p, q = _check_grid(mesh, m_tiles, row_axes, col_axes, "distributed_cholesky_fn")
    del unroll
    row_axes, col_axes = tuple(row_axes), tuple(col_axes)

    def fn(local: torch.Tensor) -> torch.Tensor:
        return _cholesky(local, mesh=mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes, p=p, q=q,
                         update_dtype=update_dtype)

    return fn


def _diagonal_tiles(local, mesh, m_tiles, row_axes, col_axes, p, q) -> torch.Tensor:
    """Every diagonal tile of the factor on every rank: one psum of the owned ones."""
    mp, mq, m, _ = local.shape
    glob_i, glob_k = _owned(mesh, row_axes, col_axes, mp, mq, p, q)
    out = local.new_zeros((m_tiles, m, m))
    ii, kk = np.nonzero(glob_i[:, None] == glob_k[None, :])
    if len(ii):
        out[_idx(glob_i[ii], local.device)] = local[_idx(ii, local.device), _idx(kk, local.device)]
    return coll.psum(out, mesh, tuple(row_axes) + tuple(col_axes))


def _forward_solve(local, diag, y, *, mesh, m_tiles, row_axes, col_axes, p, q) -> torch.Tensor:
    """L b = y with L block-cyclic and y replicated (M, m): per row, a local partial product, a psum, a solve."""
    mp, mq, m, _ = local.shape
    glob_i, glob_k = _owned(mesh, row_axes, col_axes, mp, mq, p, q)
    axes = tuple(row_axes) + tuple(col_axes)
    b = y.clone()
    for i in range(m_tiles):
        acc = y.new_zeros((m,))
        rows = np.nonzero(glob_i == i)[0]
        cols = np.nonzero(glob_k < i)[0]
        if len(rows) and len(cols):
            tiles = local[int(rows[0])].index_select(0, _idx(cols, y.device))          # (K, m, m)
            acc = torch.einsum("kab,kb->a", tiles, b.index_select(0, _idx(glob_k[cols], y.device)))
        rhs = b[i] - coll.psum(acc, mesh, axes)
        b[i] = torch.linalg.solve_triangular(diag[i], rhs[:, None], upper=False)[:, 0]
    return b


def _backward_solve(local, diag, b, *, mesh, m_tiles, row_axes, col_axes, p, q) -> torch.Tensor:
    """L^T a = b, from the stored tiles L_{k,i} with k > i."""
    mp, mq, m, _ = local.shape
    glob_i, glob_k = _owned(mesh, row_axes, col_axes, mp, mq, p, q)
    axes = tuple(row_axes) + tuple(col_axes)
    a = b.clone()
    for t in range(m_tiles):
        i = m_tiles - 1 - t
        acc = b.new_zeros((m,))
        rows = np.nonzero(glob_i > i)[0]
        cols = np.nonzero(glob_k == i)[0]
        if len(rows) and len(cols):
            tiles = local[_idx(rows, b.device), int(cols[0])]                        # (K, m, m)
            acc = torch.einsum("kba,kb->a", tiles, a.index_select(0, _idx(glob_i[rows], b.device)))
        rhs = a[i] - coll.psum(acc, mesh, axes)
        a[i] = torch.linalg.solve_triangular(diag[i].T, rhs[:, None], upper=True)[:, 0]
    return a


def _assemble(x_chunks, params, n_valid: int, *, mesh, row_axes, col_axes, p, q, table) -> torch.Tensor:
    """The rank's block-cyclic lower tiles from the replicated x chunks (strictly upper tiles zero).

    One cov_tiles launch over the owned tiles with I >= K: only the lower
    triangle is evaluated, the tiled assembly's saving (paper Fig. 4).
    """
    m_tiles, m, _ = x_chunks.shape
    mp, mq = m_tiles // p, m_tiles // q
    glob_i, glob_k = _owned(mesh, row_axes, col_axes, mp, mq, p, q)
    dev = x_chunks.device
    local = x_chunks.new_zeros((mp, mq, m, m))
    ii, kk = np.nonzero(glob_i[:, None] >= glob_k[None, :])
    if len(ii):
        gi, gk = _idx(glob_i[ii], dev), _idx(glob_k[kk], dev)
        tiles = ops.cov_tiles(x_chunks.index_select(0, gi), x_chunks.index_select(0, gk), gi * m, gk * m,
                              n_valid, n_valid, params, symmetric=True, kernel=_SE,
                              table=table)
        local[_idx(ii, dev), _idx(kk, dev)] = tiles
    return local


def _predict_mean(xt_chunks, x_chunks, alpha, params, nt_valid: int, n_valid: int, table) -> torch.Tensor:
    """K_* alpha, replicated: one cov_tiles launch over the (Mt, M) cross tiles."""
    mt, m, _ = xt_chunks.shape
    mm = x_chunks.shape[0]
    dev = x_chunks.device
    ti = torch.arange(mt, device=dev).repeat_interleave(mm)
    tk = torch.arange(mm, device=dev).repeat(mt)
    tiles = ops.cov_tiles(xt_chunks.index_select(0, ti), x_chunks.index_select(0, tk), ti * m, tk * m,
                          nt_valid, n_valid, params, symmetric=False, kernel=_SE, table=table)
    return torch.einsum("ikab,kb->ia", tiles.view(mt, mm, m, m), alpha)


def _var_step(j: int, b: torch.Tensor, local: torch.Tensor, *, mesh, m_tiles: int, row_axes, col_axes, p: int,
              q: int) -> None:
    """One row of the matrix forward solve L V = K_{X,X̂}, in place on the rank's right-hand sides b (M, Mt/Q, m, m):
    column j of L broadcast (active rows only), V_j solved, B_i -= L_ij V_j for the rows below."""
    pc = coll.linear_index(mesh, col_axes)
    ip0 = j // p
    base = ip0 * p
    col = local[ip0:, j // q] if pc == j % q else torch.zeros_like(local[ip0:, 0])
    col = coll.psum(col, mesh, col_axes)
    panel = _panel_from_gather(coll.gather_axes(col, mesh, row_axes))  # rows base ... of column j
    vj = torch.linalg.solve_triangular(panel[j - base], b[j], upper=False)  # (mtq, m, m)
    b[j] = vj
    if j + 1 < m_tiles:
        lij = panel[j + 1 - base:m_tiles - base]
        b[j + 1:] -= torch.einsum("iab,qbc->iqac", lij, vj)


def _variances(local, x_chunks, xt_chunks, params, n_valid: int, nt_valid: int, *, mesh, m_tiles, row_axes,
               col_axes, p, q, table) -> torch.Tensor:
    """diag(K_** - V^T V) with L V = K_{X,X̂}, V split over the process columns.

    Each process column owns Mt/Q test tiles: their right-hand sides are one
    cov_tiles launch, then the rows are solved in order, column J of L
    broadcast as in the factorization (active rows only).  The diagonal
    blocks of V^T V are local to a column; one gather returns the result.
    """
    m = local.shape[2]
    pc = coll.linear_index(mesh, col_axes)
    mt = xt_chunks.shape[0]
    if mt % q:
        raise ValueError(f"test tiles {mt} must divide process columns {q}")
    mtq = mt // q
    dev = local.device
    t0 = pc * mtq
    ti = torch.arange(m_tiles, device=dev).repeat_interleave(mtq)
    tc = torch.arange(t0, t0 + mtq, device=dev).repeat(m_tiles)
    b = ops.cov_tiles(x_chunks.index_select(0, ti), xt_chunks.index_select(0, tc), ti * m, tc * m, n_valid,
                      nt_valid, params, symmetric=False, kernel=_SE, table=table)
    b = b.view(m_tiles, mtq, m, m)
    for j in range(m_tiles):
        _var_step(j, b, local, mesh=mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes, p=p, q=q)
    w_diag = torch.einsum("iqab,iqab->qb", b, b)                                   # (mtq, m)
    gj = t0 * m + torch.arange(mtq, device=dev)[:, None] * m + torch.arange(m, device=dev)[None, :]
    prior = torch.as_tensor(params.vertical, dtype=w_diag.dtype, device=dev)
    var_loc = torch.where(gj < nt_valid, prior - w_diag, torch.zeros_like(w_diag))
    return coll.gather_axes(var_loc, mesh, col_axes).reshape(mt, m)


def local_covariance(mesh, x_chunks, params: km.SEKernelParams, n_valid: int, *,
                     row_axes: Tuple[str, ...] = ("data",), col_axes: Tuple[str, ...] = ("model",)) -> torch.Tensor:
    """This rank's (Mp, Mq, m, m) block of the SE covariance of the replicated x chunks (M, m, D).

    The assembly that :func:`distributed_gp_predict_fn` runs first: one
    cov_tiles launch over the owned tiles with I >= K, strictly upper tiles
    zero; the input of :func:`distributed_cholesky_fn`.
    """
    p, q = _check_grid(mesh, x_chunks.shape[0], row_axes, col_axes, "local_covariance")
    table = ops.cov_descriptor(_SE, params, x_chunks.shape[-1], x_chunks.dtype, x_chunks.device)
    return _assemble(x_chunks, params, n_valid, mesh=mesh, row_axes=tuple(row_axes), col_axes=tuple(col_axes),
                     p=p, q=q, table=table)


def distributed_gp_predict_fn(mesh, *, m_tiles: int, tile_size: int, n_valid: int, n_test_valid: int,
                              params: km.SEKernelParams, row_axes: Tuple[str, ...] = ("data",),
                              col_axes: Tuple[str, ...] = ("model",), unroll: bool = False, update_dtype=None,
                              variances: bool = True):
    """``fn(x_chunks, y_chunks, xt_chunks) -> mean [, var]``: the distributed GP prediction.

    Inputs, replicated on every rank: x_chunks (M, m, D), y_chunks (M, m),
    xt_chunks (Mt, m, D).  Returns mean (Mt, m) [and var (Mt, m)] on every
    rank.  The covariance never exists whole: each rank assembles and
    factors only its block-cyclic tiles.
    """
    p, q = _check_grid(mesh, m_tiles, row_axes, col_axes, "distributed_gp_predict_fn")
    del unroll
    row_axes, col_axes = tuple(row_axes), tuple(col_axes)
    grid = dict(mesh=mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes, p=p, q=q)

    def fn(x_chunks, y_chunks, xt_chunks):
        if x_chunks.shape[:2] != (m_tiles, tile_size):
            raise ValueError(f"x_chunks {tuple(x_chunks.shape)} must be ({m_tiles}, {tile_size}, D)")
        table = ops.cov_descriptor(_SE, params, x_chunks.shape[-1], x_chunks.dtype, x_chunks.device)
        local = _assemble(x_chunks, params, n_valid, mesh=mesh, row_axes=row_axes, col_axes=col_axes, p=p, q=q,
                          table=table)
        local = _cholesky(local, update_dtype=update_dtype, **grid)
        diag = _diagonal_tiles(local, mesh, m_tiles, row_axes, col_axes, p, q)
        beta = _forward_solve(local, diag, y_chunks.to(local.dtype), **grid)
        alpha = _backward_solve(local, diag, beta, **grid)
        mean = _predict_mean(xt_chunks, x_chunks, alpha, params, n_test_valid, n_valid, table)
        if not variances:
            return mean
        return mean, _variances(local, x_chunks, xt_chunks, params, n_valid, n_test_valid, table=table, **grid)

    return fn


def cholesky_step_probe_fn(mesh, *, m_tiles: int, row_axes: Tuple[str, ...] = ("data",),
                           col_axes: Tuple[str, ...] = ("model",), update_dtype=None):
    """``fn(local, j) -> local after step j``: one factorization step alone, on a copy of the rank's block.

    The launch tools' per-step breakdown.  The port's steps shrink with j
    (active slices), so step 0 is the widest: its cost times M bounds the
    factorization from above (the reference's masked steps cost the same at
    every j).
    """
    p, q = _check_grid(mesh, m_tiles, row_axes, col_axes, "cholesky_step_probe_fn")
    row_axes, col_axes = tuple(row_axes), tuple(col_axes)

    def fn(local: torch.Tensor, j: int) -> torch.Tensor:
        local = local.clone()
        _chol_step(int(j), local, mesh=mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes, p=p, q=q,
                   update_dtype=update_dtype)
        return local

    return fn


def variance_step_probe_fn(mesh, *, m_tiles: int, row_axes: Tuple[str, ...] = ("data",),
                           col_axes: Tuple[str, ...] = ("model",)):
    """``fn(local, b, j) -> b after step j``: one row of the variances' matrix forward solve alone.

    ``local`` is the rank's factored block, ``b`` its (M, Mt/Q, m, m)
    right-hand sides (a copy is solved).
    """
    p, q = _check_grid(mesh, m_tiles, row_axes, col_axes, "variance_step_probe_fn")
    row_axes, col_axes = tuple(row_axes), tuple(col_axes)

    def fn(local: torch.Tensor, b: torch.Tensor, j: int) -> torch.Tensor:
        b = b.clone()
        _var_step(int(j), b, local, mesh=mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes, p=p, q=q)
        return b

    return fn


def schedule_launches(m_tiles: int, p: int, q: int, pr: int, pc: int, *, predict: bool = False,
                      variances: bool = True) -> Dict[str, int]:
    """The kernel launches of one rank at grid position (pr, pc), from the schedule.

    POTRF and TRSM launch once a step on every rank; TRAIL once a step in
    which the rank owns a tile (I, K) with I >= K > J; cov_tiles once for
    the assembly, once for the mean's cross tiles and once for the variance
    right-hand sides.
    """
    glob_i = np.arange(m_tiles // p) * p + pr
    glob_k = np.arange(m_tiles // q) * q + pc
    trail = sum(bool(((glob_i[:, None] > j) & (glob_k[None, :] > j) & (glob_i[:, None] >= glob_k[None, :])).any())
                for j in range(m_tiles))
    cov = (2 + int(variances)) if predict else 0
    return {"cov_tiles": cov, "potrf": m_tiles, "trsm": m_tiles, "trail": trail}


def _cyclic_positions(m_tiles: int, p: int, q: int):
    mp, mq = m_tiles // p, m_tiles // q
    pos_r = np.array([(i % p) * mp + i // p for i in range(m_tiles)])
    pos_c = np.array([(j % q) * mq + j // q for j in range(m_tiles)])
    return pos_r, pos_c


def to_cyclic_layout(tiles, p: int, q: int):
    """(M, M, m, m) natural tile grid -> the global cyclic store.

    Natural tile (I, J) moves to (I % P * Mp + I // P, J % Q * Mq + J // Q),
    so that the rank at grid position (r, c) holds rows [r Mp, (r+1) Mp) and
    columns [c Mq, (c+1) Mq) of the store, tile (I, J) at local slot
    (I // P, J // Q).
    """
    pos_r, pos_c = _cyclic_positions(tiles.shape[0], p, q)
    return tiles[np.argsort(pos_r)][:, np.argsort(pos_c)]


def from_cyclic_layout(tiles, p: int, q: int):
    pos_r, pos_c = _cyclic_positions(tiles.shape[0], p, q)
    return tiles[pos_r][:, pos_c]


def local_block(cyclic: torch.Tensor, mesh, row_axes: Sequence[str] = ("data",),
                col_axes: Sequence[str] = ("model",)) -> torch.Tensor:
    """This rank's (Mp, Mq, m, m) block of the global (M, M, m, m) cyclic store (a copy)."""
    p, q = grid_shape(mesh, row_axes, col_axes)
    mp, mq = cyclic.shape[0] // p, cyclic.shape[1] // q
    pr, pc = coll.linear_index(mesh, row_axes), coll.linear_index(mesh, col_axes)
    return cyclic[pr * mp:(pr + 1) * mp, pc * mq:(pc + 1) * mq].clone()


def collect_blocks(local: torch.Tensor, mesh, row_axes: Sequence[str] = ("data",),
                   col_axes: Sequence[str] = ("model",)) -> torch.Tensor:
    """The global (M, M, m, m) cyclic store from every rank's block (one gather), on every rank."""
    p, q = grid_shape(mesh, row_axes, col_axes)
    mp, mq, m, mb = local.shape
    blocks = coll.gather_axes(local, mesh, tuple(row_axes) + tuple(col_axes))       # (P * Q, Mp, Mq, m, m)
    return blocks.view(p, q, mp, mq, m, mb).permute(0, 2, 1, 3, 4, 5).reshape(p * mp, q * mq, m, mb)
