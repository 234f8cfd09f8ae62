"""Streaming posterior maintenance: block Cholesky append / evict.

The counterpart of ``repro/core/update.py``.  It turns a cached
:class:`repro_torch.core.predict.PosteriorState`, of one problem or of a
fleet's B stacked problems, into a live one:

* :func:`extend_state` absorbs b new observations in O(n^2 b) by growing
  the packed factor one tile-row at a time (the append DAG of
  ``scheduler.append_tasks``, run by ``executor.run_append``).  A partially
  padded trailing tile is refilled in place first, so the padding always
  stays at the end of the store, which keeps the scalar ``n_valid``
  masking of the assembly kernel exact.
* :func:`shrink_state` evicts the k oldest observations (sliding window) in
  O(n^2 k): dropping the leading tile-column of a factor is a positive
  rank-m update of the trailing block (K22 = L21 L21^T + L22 L22^T), run as
  the blocked cholupdate sweep of ``executor.run_rank_update``.
  :func:`downdate_factor` is the true hyperbolic downdate (``sign=-1``).
* :func:`extend_state_ragged` absorbs a different count per problem into a
  ragged bucket's state (per-problem frontiers ``n_valid``): the arrivals
  are scattered at each problem's frontier, then the affected tile-rows
  are recomputed for the whole bucket, lowest first.

The forward-solve chunks beta grow incrementally (the prefix rows of a
grown triangular system never change) and alpha is re-solved with one
O(n^2) backward substitution, so ``predict`` after an update never re-runs
the O(n^3) program.  Every entry point works on copies: the input state is
left unchanged, as the JAX package's immutable arrays leave it.

A failed Cholesky head (a non-PD downdate) surfaces as NaN from the POTRF
kernel; :func:`_check` turns it into :class:`CholeskyUpdateError`, which
``GaussianProcess.update`` / ``forget`` (and the fleets') catch to
refactorize instead.  It, and the ragged sweep's reading of the bucket's
frontiers, are the only places here that read a device value on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

import repro_torch.obs as obs
from repro_torch.core import executor
from repro_torch.core import kernels_math as km
from repro_torch.core import predict as pred
from repro_torch.core import tiling, triangular


class CholeskyUpdateError(RuntimeError):
    """The incremental factor update went numerically bad (NaN heads).

    Raised after the fact, since the returned state would be poisoned, so
    callers can fall back to a full refactorization of the grown or shrunk
    dataset."""


def _check(t: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(t).all()):
        obs.health_event("nan_guard_trip", what=what)
        raise CholeskyUpdateError(
            f"incremental {what} went non-finite (non-positive-definite head); "
            "fall back to a full refactorization"
        )


def _live_chunks(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beta, y_chunks); a state without them gets them from the factor:
    beta = L^T alpha and y = L beta are two O(n^2) packed matvecs."""
    beta = state.beta
    if beta is None:
        beta = triangular.packed_matvec(state.lpacked, state.alpha, transpose=True)
    yc = state.y_chunks
    if yc is None:
        yc = triangular.packed_matvec(state.lpacked, beta, transpose=False)
    return beta, yc


def _append_row(lpacked, xc, yc, beta, x_row, y_row, params, r_tiles, n_valid_new, grow, *,
                n_streams, update_dtype, batch_dispatch, kernel):
    """One tile-row append: solve the row, repack the store, extend beta.

    Every operand may carry the leading problem axis B.  Returns new
    (lpacked, xc, yc, beta); the inputs are not modified.
    """
    dev = lpacked.device
    batched = xc.ndim == 4
    row = executor.run_append(
        lpacked, xc, x_row, params, r_tiles, n_valid_new,
        n_streams=n_streams, update_dtype=update_dtype, batch_dispatch=batch_dispatch,
        kernel=kernel, device=dev,
    )
    # beta_R = corner^{-1} (y_row - sum_{j<R} row_j beta_j): the prefix of a
    # grown forward-triangular system never changes.
    s = torch.einsum("...jab,...jb->...a", row[..., :r_tiles, :, :], beta[..., :r_tiles, :])
    corner = row[..., r_tiles, :, :]
    rhs = (y_row - s).to(corner.dtype)[..., None]
    beta_new = torch.linalg.solve_triangular(corner, rhs, upper=False)[..., 0]
    axis = 1 if batched else 0
    if grow:
        idx = torch.from_numpy(tiling.grow_packed_indices(xc.shape[-3])).to(dev)
        lpacked = torch.cat([lpacked, row], dim=axis).index_select(axis, idx)
        xc = torch.cat([xc, x_row.unsqueeze(axis)], dim=axis)
        yc = torch.cat([yc, y_row.unsqueeze(axis)], dim=axis)
        beta = torch.cat([beta, beta_new.unsqueeze(axis)], dim=axis)
    else:
        slots = torch.from_numpy(tiling.replace_row_indices(r_tiles, xc.shape[-3])).to(dev)
        lpacked = lpacked.index_copy(axis, slots, row)
        xc, yc, beta = xc.clone(), yc.clone(), beta.clone()
        xc[..., r_tiles, :, :] = x_row
        yc[..., r_tiles, :] = y_row
        beta[..., r_tiles, :] = beta_new
    return lpacked, xc, yc, beta


def extend_state(
    state,
    x_new,
    y_new,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    batch_dispatch: str = "flat",
):
    """Absorb new observations into a cached posterior in O(n^2 b).

    x_new (b, D) (or (b,) for a 1-D problem) and y_new (b,) go to the
    state's device and dtype; a fleet's stacked state takes (B, b, D) and
    (B, b), the same count b for every problem, which keeps the fleet on
    one tile geometry.  Returns a new
    :class:`~repro_torch.core.predict.PosteriorState`; the input state is
    unchanged.  A partially padded trailing tile is refilled first
    (recomputing only that row), then whole new rows are appended, each
    O(n^2 m).  beta grows incrementally; alpha is re-solved with one O(n^2)
    backward substitution at the end.
    """
    m, dev = state.m, state.device
    dtype = state.x_chunks.dtype
    batched = state.x_chunks.ndim == 4
    x_new = torch.as_tensor(x_new, device=dev).to(dtype)
    y_new = torch.as_tensor(y_new, device=dev).to(dtype)
    if x_new.ndim == (2 if batched else 1):  # 1-D problem convenience
        x_new = x_new[..., None]
    d = state.x_chunks.shape[-1]
    if x_new.ndim != (3 if batched else 2) or x_new.shape[-1] != d or y_new.shape != x_new.shape[:-1]:
        raise ValueError(
            f"x_new must be {'(B, b, D)' if batched else '(b, D)'} with D == {d} and matching "
            f"y_new; got x {tuple(x_new.shape)}, y {tuple(y_new.shape)}"
        )
    b_total = x_new.shape[-2]
    if b_total == 0:
        return state

    lpacked, xc = state.lpacked, state.x_chunks
    beta, yc = _live_chunks(state)
    n = state.n
    consumed = 0
    while consumed < b_total:
        r = n % m
        grow = r == 0
        r_tiles = n // m  # row index R being appended / refilled
        take = min(m - r, b_total - consumed)
        if grow:
            x_row = x_new.new_zeros(x_new.shape[:-2] + (m, d))
            y_row = y_new.new_zeros(y_new.shape[:-1] + (m,))
        else:
            x_row, y_row = xc[..., r_tiles, :, :].clone(), yc[..., r_tiles, :].clone()
        x_row[..., r : r + take, :] = x_new[..., consumed : consumed + take, :]
        y_row[..., r : r + take] = y_new[..., consumed : consumed + take]
        lpacked, xc, yc, beta = _append_row(
            lpacked, xc, yc, beta, x_row, y_row, state.params, r_tiles, n + take, grow,
            n_streams=n_streams, update_dtype=update_dtype, batch_dispatch=batch_dispatch,
            kernel=state.kernel,
        )
        n += take
        consumed += take

    alpha = triangular.backward_substitution(lpacked, beta, n_streams=n_streams, device=dev)
    _check(alpha, "append")
    return pred.PosteriorState(
        lpacked=lpacked, alpha=alpha, x_chunks=xc, n=n, m=m,
        params=state.params, beta=beta, y_chunks=yc, kernel=state.kernel,
    )


def extend_state_ragged(
    state,
    x_new,
    y_new,
    counts,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    batch_dispatch: str = "flat",
):
    """Absorb per-problem arrival counts into a ragged bucket's stacked state.

    ``state`` stacks B problems of one tile geometry with per-problem
    frontiers ``state.n_valid``; ``x_new`` (B, b_max, D) holds problem i's
    arrivals in its leading ``counts[i]`` rows (the rest is ignored),
    ``y_new`` (B, b_max), ``counts`` a host (B,) integer vector.  Every
    problem must stay within the bucket's capacity: crossing a boundary is
    a migration, which ``GPFleet`` does by re-embedding the factor first
    (``tiling.embed_packed``).

    The sweep: scatter every arrival into the feature and target chunks at
    its problem's frontier, then recompute tile-rows R = min_i floor(n_i/m)
    ... max_i ceil(n_i'/m) - 1, lowest first, for the whole bucket, with
    the new per-problem frontiers masking both axes.  Recomputing a row is
    idempotent: a problem with no arrival at row R reproduces its row (the
    same masked assembly against the same frozen prefix), and one whose
    frontier lies below R reproduces identity padding, so one append plan
    per row serves every mix of arrivals.  Raises
    :class:`CholeskyUpdateError` when the refreshed weights go non-finite.
    """
    if state.x_chunks.ndim != 4:
        raise ValueError("extend_state_ragged needs a stacked (B, ...) state")
    if state.n_valid is None:
        raise ValueError("extend_state_ragged needs a state with n_valid")
    m, dev = state.m, state.device
    dtype = state.x_chunks.dtype
    bsz, m_store, _, d = state.x_chunks.shape
    capacity = m_store * m
    x_new = torch.as_tensor(x_new, device=dev).to(dtype)
    y_new = torch.as_tensor(y_new, device=dev).to(dtype)
    if x_new.ndim == 2:  # 1-D problem convenience
        x_new = x_new[..., None]
    counts = torch.as_tensor(counts, dtype=torch.int64).reshape(-1).cpu()
    if (
        x_new.ndim != 3 or x_new.shape[0] != bsz or x_new.shape[-1] != d
        or y_new.shape != x_new.shape[:-1] or counts.shape != (bsz,)
    ):
        raise ValueError(
            f"need x_new (B, b_max, D={d}), matching y_new and counts (B,); got x "
            f"{tuple(x_new.shape)}, y {tuple(y_new.shape)}, counts {tuple(counts.shape)}"
        )
    b_max = x_new.shape[1]
    if bool((counts < 0).any()) or bool((counts > b_max).any()):
        raise ValueError(f"counts must lie in [0, b_max={b_max}]: {counts.tolist()}")
    n_old = state.n_valid.to(torch.int64).cpu()  # the sweep's rows are a host decision
    n_new = n_old + counts
    if bool((n_new > capacity).any()):
        over = torch.nonzero(n_new > capacity).reshape(-1).tolist()
        raise ValueError(
            f"problems {over} would outgrow the bucket capacity {capacity}; migrate them "
            "to a larger geometry first (GPFleet does)"
        )
    if not bool((counts > 0).any()):
        return state

    beta, yc = _live_chunks(state)
    lpacked = state.lpacked
    # 1) scatter the arrivals at each problem's frontier; rows past counts[i] drop
    prob, arrival = torch.nonzero(torch.arange(b_max)[None, :] < counts[:, None], as_tuple=True)
    prob, arrival, pos = (km._to_device(t, dev) for t in (prob, arrival, n_old[prob] + arrival))
    xf = state.x_chunks.reshape(bsz, capacity, d).clone()
    yf = yc.reshape(bsz, capacity).clone()
    xf[prob, pos] = x_new[prob, arrival]
    yf[prob, pos] = y_new[prob, arrival]
    xc = xf.reshape(bsz, m_store, m, d)
    yc = yf.reshape(bsz, m_store, m)

    # 2) recompute the affected tile-rows, lowest first, for the whole bucket
    growing = counts > 0
    r_lo = int(n_old[growing].min()) // m
    r_hi = int((n_new[growing] - 1).max()) // m
    nv_new = n_new.to(torch.int32)
    nv_dev = km._to_device(nv_new, dev)
    for r in range(r_lo, r_hi + 1):
        lpacked, xc, yc, beta = _append_row(
            lpacked, xc, yc, beta, xc[:, r], yc[:, r], state.params, r, nv_dev, False,
            n_streams=n_streams, update_dtype=update_dtype, batch_dispatch=batch_dispatch,
            kernel=state.kernel,
        )

    alpha = triangular.backward_substitution(lpacked, beta, n_streams=n_streams, device=dev)
    _check(alpha, "ragged append")
    return pred.PosteriorState(
        lpacked=lpacked, alpha=alpha, x_chunks=xc, n=state.n, m=m, params=state.params,
        beta=beta, y_chunks=yc, n_valid=nv_dev, kernel=state.kernel,
    )


def shrink_state(
    state,
    k: int,
    *,
    n_streams: Optional[int] = None,
    batch_dispatch: str = "flat",
):
    """Evict the k oldest observations from a cached posterior in O(n^2 k).

    ``k`` must be a multiple of the tile size (whole leading tile-columns:
    ``GaussianProcess.forget`` refactorizes for an unaligned k) and must
    leave at least one valid observation.  Each evicted column is a positive
    rank-m update of the trailing factor; beta and alpha are re-solved with
    one O(n^2) forward and backward substitution at the end.  A fleet's
    stacked state evicts k rows of every problem.  The input state is
    unchanged.
    """
    m, dev = state.m, state.device
    if k == 0:
        return state
    if k % m != 0:
        raise ValueError(
            f"shrink_state evicts whole leading tiles: k={k} is not a "
            f"multiple of the tile size {m} (refactorize instead)"
        )
    t = k // m
    m_tiles = state.x_chunks.shape[-3]
    if t >= m_tiles or k >= state.n:
        raise ValueError(f"cannot evict {k} of {state.n} observations ({m_tiles} tiles)")
    axis = 1 if state.x_chunks.ndim == 4 else 0
    _, yc = _live_chunks(state)
    lpacked = state.lpacked
    for step in range(t):
        trailing, evicted = (
            torch.from_numpy(a).to(dev) for a in tiling.shrink_packed_indices(m_tiles - step)
        )
        lpacked, _ = executor.run_rank_update(
            lpacked.index_select(axis, trailing), lpacked.index_select(axis, evicted),
            sign=1.0, n_streams=n_streams, batch_dispatch=batch_dispatch, device=dev,
        )
    xc = state.x_chunks.narrow(axis, t, m_tiles - t).clone()
    yc = yc.narrow(axis, t, m_tiles - t).clone()
    beta = triangular.forward_substitution(lpacked, yc, n_streams=n_streams, device=dev)
    alpha = triangular.backward_substitution(lpacked, beta, n_streams=n_streams, device=dev)
    _check(alpha, "evict")
    return pred.PosteriorState(
        lpacked=lpacked, alpha=alpha, x_chunks=xc, n=state.n - k, m=m,
        params=state.params, beta=beta, y_chunks=yc, kernel=state.kernel,
    )


def downdate_factor(
    lpacked,
    w,
    *,
    n_streams: Optional[int] = None,
    device="cuda",
) -> torch.Tensor:
    """True rank-b downdate: chol(L L^T - W W^T) via hyperbolic rotations.

    w: (M, m, m) carry blocks (zero-padded beyond the rank).  Raises
    :class:`CholeskyUpdateError` when L L^T - W W^T is not positive
    definite (the Cholesky heads go NaN).  The inverse of
    :func:`update_factor`.
    """
    new_packed, _ = executor.run_rank_update(
        lpacked, w, sign=-1.0, n_streams=n_streams, device=device
    )
    _check(new_packed, "downdate")
    return new_packed


def update_factor(
    lpacked,
    w,
    *,
    n_streams: Optional[int] = None,
    device="cuda",
) -> torch.Tensor:
    """Positive rank-b update: chol(L L^T + W W^T) (always PD in exact
    arithmetic; NaN-checked for numerical failures)."""
    new_packed, _ = executor.run_rank_update(
        lpacked, w, sign=1.0, n_streams=n_streams, device=device
    )
    _check(new_packed, "update")
    return new_packed
