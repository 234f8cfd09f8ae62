"""Tiled Nystrom low-rank tier: O(n m^2) approximate GP regression, in PyTorch.

The counterpart of ``repro/core/lowrank.py`` for a single problem.  The
exact tier factors the n x n covariance; this tier factors only the m x m
inner system of the DTC/Nystrom approximation (m = number of inducing
points, m << n):

    A  = K_uu + s^-2 K_un K_nu                     (m x m)
    mu* = s^-2 K_*u A^-1 K_un y
    S*  = K_** - K_*u K_uu^-1 K_u* + K_*u A^-1 K_u*

Everything n-sized goes through the tiled machinery of the exact tier: K_un
is a (MU x M) tile grid assembled by one ``cov_tiles`` launch, the
contraction c = K_un y is the LRGEMM family (one ``lrgemm`` launch,
``executor.run_lowrank_contraction``), and both m x m factorizations run
the tiled Cholesky (``potrf``/``trsm``/``trail``).

The inner system is held in whitened (SGPR) form: with W = L_uu^-1 K_un,

    B = I + s^-2 W W^T        so that        A = L_uu B L_uu^T.

A is badly conditioned in float32 (its scale grows like s^-2 n while its
smallest eigenvalue is the K_uu jitter), but B's eigenvalues are >= 1, so
chol(B) does not go indefinite.  Every A^-1 is a sandwich of four tiled
triangular solves, and log det A - log det K_uu = log det B.

One deliberate difference from the reference, in how gamma = A^-1 c is
solved.  The reference solves it from c = K_un y: L_uu^-T B^-1 L_uu^-1 c.
In float32 the rounding of L_uu^-1 c and of W = L_uu^-1 K_un (from which B
is built) then disagree, and L_uu's condition number (~sqrt(m / jitter))
amplifies the disagreement: at gp_256k (m = 2048, jitter 1e-4) the mean
sigma^-2 K_*u gamma lost ~8% of its scale against a float64 DTC, as did a
dense float32 pipeline with the same formulas.  The port also contracts
the whitened grid, c_w = W y (a second ``lrgemm`` launch over a grid of the
same shape), and solves gamma = L_uu^-T B^-1 c_w, so that B and the
right-hand side come from one W; the mean then agrees with the dense
float32 SGPR pipeline.  ``c_chunks`` is kept as the reference computes it
(K_un y), for :func:`nlml_from_lowrank_state`, and the head is the
reference's; :func:`whitened_nlml` takes the NLML's quadratic term in the
same whitened coordinates as gamma.

:func:`absorb` adds (``sign=+1``) or removes (``sign=-1``) a block of
training rows through the rank-m inner system in O(b m^2 + m^3); the
inducing set stays fixed.  A removal that leaves B indefinite raises
:class:`repro_torch.core.update.CholeskyUpdateError`.

The plain products of the JAX package (the Gram of W, the head's mean and
covariance contractions) stay ``torch.matmul``/``torch.einsum``, with TF32
off on the card.  Every entry point takes B stacked problems of one size
((B, n, D) inputs; a state's tensors gain the leading B axis), with shared
or per-problem ((B,) leaves) hyperparameters: each launch then covers the
B problems' tiles (``GPBatch(method="lowrank")``).  Ragged problems,
zero-padded to one capacity, pass per-problem frontiers: ``n_valid`` (B,)
to :func:`lowrank_state`, ``counts`` (B,) to :func:`absorb` and
``nt_valid`` (B,) to :func:`predict_from_lowrank_state`
(``GPFleet(method="lowrank")``).  The frontiers stay (B,) int32 tensors on
the device and go to cov_tiles as row/column frontiers; no entry point
reads one on the host.  Each problem's count of distinct inducing points,
``mu_valid = min(m_inducing, n_valid)``, is such a tensor too: K_uu's rows
past it keep their identity pin, so they add log 1 to log det B.  The
NLML's gradient and training are :func:`repro_torch.core.mll.nlml_lowrank`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import executor
from repro_torch.core import kernels_math as km
from repro_torch.core import predict as pred
from repro_torch.core import tiling, triangular
from repro_torch.core import update as upd
from repro_torch.device import resolve_device

# K_uu is regularized with a small jitter (not the noise variance), so the
# approximation converges to the exact GP as m -> n.  1e-4 is the float32
# floor: SE Gram matrices are numerically rank-deficient and chol(K_uu)
# needs the jitter to dominate the ~eps * m roundoff of the factorization;
# pass a smaller value explicitly for float64 states.
DEFAULT_JITTER = 1e-4


# ---------------------------------------------------------------------------
# Inducing-point selection.
# ---------------------------------------------------------------------------


def _subset_indices(mu: int, nv, device) -> torch.Tensor:
    """Strided subset indices: distinct for the first min(mu, nv) rows even
    when nv < mu (the tail repeats the last point).  ``nv`` an int gives
    (mu,); a tensor of counts (a 0-d or (B,)) gives ``nv.shape + (mu,)``,
    computed on the device."""
    if isinstance(nv, torch.Tensor):
        nv = nv.to(device=device, dtype=torch.int64)[..., None]
        idx = torch.arange(mu, dtype=torch.int64, device=device) * nv // nv.clamp(min=1, max=mu)
        return torch.minimum(idx, (nv - 1).clamp(min=0))
    step = max(min(mu, nv), 1)
    idx = torch.arange(mu, dtype=torch.int64, device=device) * nv // step
    return idx.clamp(0, max(nv - 1, 0))


def _kmeans_lite(x: torch.Tensor, mu: int, nv: int, iters: int) -> torch.Tensor:
    """A few Lloyd iterations from the strided subset; rows >= nv are masked out."""
    centers = x[_subset_indices(mu, nv, x.device)]
    valid = (torch.arange(x.shape[0], device=x.device) < nv)[:, None]
    for _ in range(iters):
        assign = torch.argmin(km.sq_dists(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, mu).to(x.dtype) * valid
        counts = onehot.sum(0)
        sums = onehot.T @ x
        centers = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers
        )
    return centers


def _select_one(x, m_inducing, strategy, nv, kmeans_iters):
    if strategy == "subset":
        return x[_subset_indices(m_inducing, nv, x.device)]
    if strategy == "kmeans-lite":
        return _kmeans_lite(x, m_inducing, nv, kmeans_iters)
    raise ValueError(f"unknown inducing strategy: {strategy!r}")


def select_inducing(
    x: torch.Tensor,
    m_inducing: int,
    *,
    strategy: str = "subset",
    inducing=None,
    n_valid=None,
    kmeans_iters: int = 4,
) -> Tuple[torch.Tensor, Optional[Union[int, torch.Tensor]]]:
    """Pick inducing inputs u (m_inducing, D) from training inputs x (n, D).

    Returns ``(u, mu_valid)``: ``mu_valid`` is the count of distinct
    inducing points when it is below ``m_inducing`` (n < m_inducing), else
    None.  An explicit ``inducing`` set is taken as it is, in x's dtype and
    device.  u is detached: the inducing set is fixed data, not a parameter.
    Stacked x (B, n, D) gives u (B, m_inducing, D), one set per problem; an
    explicit (m_inducing, D) set is then shared by every problem.

    ``n_valid`` marks ragged problems (rows past it are padding): an int for
    one problem, or (B,) counts for stacked x.  Each problem then draws only
    from its first ``n_valid[i]`` rows, and ``mu_valid`` is the (B,) int32
    tensor ``min(m_inducing, n_valid)`` on x's device.
    """
    batched = x.ndim == 3
    if inducing is not None:
        u = torch.as_tensor(inducing, device=x.device).to(x.dtype)
        if u.ndim not in ((2, 3) if batched else (2,)) or u.shape[-2] != m_inducing:
            raise ValueError(
                f"explicit inducing set has shape {tuple(u.shape)}, expected "
                f"({'(B,) ' if batched else ''}m_inducing={m_inducing}, D)"
            )
        if batched and u.ndim == 2:
            u = u.expand((x.shape[0],) + u.shape)
        return u.detach(), None
    if batched and n_valid is not None:
        nv = pred._valid(n_valid, x.device)
        if strategy == "subset":
            idx = _subset_indices(m_inducing, nv, x.device)  # (B, m_inducing)
            u = torch.gather(x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))
        else:
            u = torch.stack([_select_one(xi, m_inducing, strategy, nvi, kmeans_iters) for xi, nvi in zip(x, nv)])
        return u.detach(), nv.clamp(max=m_inducing)
    nv = x.shape[-2] if n_valid is None else int(n_valid)
    if batched and strategy == "subset":  # one index set serves every problem of one size
        u = x[:, _subset_indices(m_inducing, nv, x.device)]
    elif batched:
        u = torch.stack([_select_one(xi, m_inducing, strategy, nv, kmeans_iters) for xi in x])
    else:
        u = _select_one(x, m_inducing, strategy, nv, kmeans_iters)
    mu_valid = min(m_inducing, nv)
    return u.detach(), None if mu_valid == m_inducing else mu_valid


# ---------------------------------------------------------------------------
# Low-rank posterior state.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LowRankState:
    """Cached Nystrom pieces: all that O(m^2)-per-test-point prediction and
    O(b m^2 + m^3) absorption of new data need.  Nothing here is n-sized."""

    u_chunks: torch.Tensor    # ((B,) MU, m, D) padded inducing chunks
    luu_packed: torch.Tensor  # packed lower tiles of chol(K_uu + jitter I)
    b_packed: torch.Tensor    # packed lower tiles of B = I + s^-2 W W^T (unfactored)
    lb_packed: torch.Tensor   # packed lower tiles of chol(B)
    c_chunks: torch.Tensor    # (MU, m) tiled c = K_un y
    gamma: torch.Tensor       # (MU, m) tiled A^-1 c, solved as L_uu^-T B^-1 c_w
    c_w: torch.Tensor         # (MU, m) tiled W y (= L_uu^-1 c), contracted from W itself
    yty: torch.Tensor         # 0-d (or (B,)): y^T y
    n: int                    # training rows absorbed (the padded count of a ragged state)
    m: int                    # tile size
    m_inducing: int
    params: object
    jitter: float
    # distinct inducing points, when < m_inducing: an int, or (B,) int32 on the device
    mu_valid: Optional[Union[int, torch.Tensor]] = None
    n_valid: Optional[torch.Tensor] = None  # (B,) int32 on the device: a ragged state's rows
    kernel: km.Kernel = km.SQUARED_EXPONENTIAL

    @property
    def device(self) -> torch.device:
        return self.c_chunks.device


# ---------------------------------------------------------------------------
# Assembly helpers.
# ---------------------------------------------------------------------------


def _mu_valid(state: LowRankState):
    return state.m_inducing if state.mu_valid is None else state.mu_valid


def _masked_yty(yc: torch.Tensor, nv) -> torch.Tensor:
    """sum y^2 over each problem's rows below ``nv`` (an int or (B,)): rows
    past the frontier may hold a caller's padding, not zeros."""
    row = torch.arange(yc.shape[-2] * yc.shape[-1], device=yc.device).reshape(yc.shape[-2:])
    if isinstance(nv, torch.Tensor):
        mask = row < nv.reshape(nv.shape + (1, 1))
    else:
        mask = row < nv
    return triangular.problem_sums(torch.where(mask, yc * yc, torch.zeros((), dtype=yc.dtype, device=yc.device)))


def _noise(kernel, params, like: torch.Tensor) -> torch.Tensor:
    """The noise variance as a tensor of ``like``'s dtype and device: 0-d, or (B,) per problem."""
    return torch.as_tensor(kernel.noise(params), dtype=like.dtype, device=like.device)


def _lift(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A 0-d or (B,) value shaped to broadcast against a ((B,) ...) tensor of ``ndim`` trailing dims."""
    return v.reshape(v.shape + (1,) * ndim)


def _retune_diag(packed, mu_tiles: int, m: int, delta, mu_valid) -> torch.Tensor:
    """Shift the valid diagonal of packed symmetric tiles by ``delta``, in place.

    Symmetric assembly pins the diagonal to diag + noise; the inner matrices
    want jitter instead, so the diagonal is corrected after assembly by
    delta = jitter - noise on rows < mu_valid (padding rows keep their
    identity pin).  Two roundings, as the reference makes them.
    ``mu_valid`` is an int or a (B,) tensor of per-problem rows.
    """
    axis = packed.ndim - 3
    idx = torch.from_numpy(triangular._diag_slots(mu_tiles)).to(packed.device)
    diag = packed.index_select(axis, idx)  # ((B,) MU, m, m)
    row = torch.arange(mu_tiles * m, device=packed.device).reshape(mu_tiles, m)
    zero = torch.zeros((), dtype=packed.dtype, device=packed.device)
    if isinstance(mu_valid, torch.Tensor):
        mu_valid = _lift(mu_valid, 2)
    shift = torch.where(row < mu_valid, _lift(delta, 2), zero)  # ((B,) MU, m)
    packed.index_copy_(axis, idx, diag + torch.diag_embed(shift))
    return packed


def _packed_from_grid(grid: torch.Tensor, mu_tiles: int) -> torch.Tensor:
    """The lower-triangle tiles of a symmetric ((B,) MU, MU, m, m) grid, in packed order."""
    rows, cols = (torch.from_numpy(a).to(grid.device) for a in tiling._packed_coords(mu_tiles))
    return grid[..., rows, cols, :, :]


def _packed_eye(mu_tiles: int, m: int, dtype, device) -> torch.Tensor:
    """Packed lower tiles of the (MU m x MU m) identity."""
    rows, cols = tiling._packed_coords(mu_tiles)
    base = torch.zeros((len(rows), m, m), dtype=dtype, device=device)
    base[torch.from_numpy(rows == cols).to(device)] = torch.eye(m, dtype=dtype, device=device)
    return base


def _gram_packed(w: torch.Tensor) -> torch.Tensor:
    """Packed lower tiles of W W^T for a ((B,) MU, M, m, mb) tile grid W.

    ``einsum("pjac,qjbc->pqab", w, w)`` of the reference, written as one
    matrix product over a single (MU m, M mb) row-major copy of W, so the
    grid (2 GiB at gp_256k) is permuted once, not once per operand.
    """
    lead = w.shape[:-4]
    mu_tiles, n_tiles, m, mb = w.shape[-4:]
    wf = w.transpose(-3, -2).reshape(lead + (mu_tiles * m, n_tiles * mb))
    gram = (wf @ wf.mT).reshape(lead + (mu_tiles, m, mu_tiles, m)).transpose(-3, -2)
    return _packed_from_grid(gram, mu_tiles)


def _inner_solve(luu, lb, c_w, n_streams, device) -> torch.Tensor:
    """gamma = A^-1 c = L_uu^-T L_B^-T L_B^-1 c_w, from the whitened
    right-hand side c_w = L_uu^-1 c (three tiled triangular sweeps)."""
    z = executor.run_solve(lb, c_w, lower=True, n_streams=n_streams, device=device)
    z = executor.run_solve(lb, z, lower=False, n_streams=n_streams, device=device)
    return executor.run_solve(luu, z, lower=False, n_streams=n_streams, device=device)


# ---------------------------------------------------------------------------
# State construction.
# ---------------------------------------------------------------------------


def lowrank_state(
    x,
    y,
    params,
    m_inducing: int,
    tile_size: int,
    *,
    strategy: str = "subset",
    inducing=None,
    jitter: float = DEFAULT_JITTER,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=torch.float32,
    batch_dispatch: str = "flat",
    n_valid=None,
    kernel=None,
    device="cuda",
) -> LowRankState:
    """Build the Nystrom low-rank posterior state of x (n, D), y (n,).

    Launches on the card: two ``cov_tiles`` (K_uu and K_un), two ``lrgemm``
    (c = K_un y and c_w = W y) and the tiled Cholesky of K_uu and of B; the
    solves and the Gram of W are plain torch.  K_un and W are freed before
    B is factored.  Stacked x (B, n, D) / y (B, n) build B states at once,
    each launch over the B problems' tiles.  ``n_valid`` (an int, or (B,)
    for stacked x) marks ragged problems: rows past it are padding, masked
    out of K_un (a column frontier of its cov_tiles launch) and of y^T y.
    """
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    x = torch.as_tensor(x, device=dev).to(dtype)
    y = torch.as_tensor(y, device=dev).to(dtype)
    batched = x.ndim == 3
    y = y.reshape(y.shape[0], -1) if batched else y.reshape(-1)
    if x.ndim not in (2, 3) or x.shape[:-1] != y.shape:
        raise ValueError(
            f"lowrank_state takes x (n, D) and y (n,), or (B, n, D) and (B, n); got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    n = x.shape[-2]
    if n_valid is not None:
        n_valid = pred._valid(n_valid, dev) if batched else int(n_valid)
    nv = n if n_valid is None else n_valid
    u, mu_valid = select_inducing(x, m_inducing, strategy=strategy, inducing=inducing, n_valid=n_valid)
    uc = tiling.pad_features(u, tile_size)
    xc = tiling.pad_features(x, tile_size)
    yc = tiling.pad_vector(y, tile_size)
    mv = m_inducing if mu_valid is None else mu_valid
    mu_tiles = uc.shape[-3]
    noise = _noise(kernel, params, yc)
    bd = batch_dispatch

    kuu = pred.assemble_packed_covariance(uc, params, mv, kernel=kernel, batch_dispatch=bd)
    kuu = _retune_diag(kuu, mu_tiles, tile_size, torch.as_tensor(jitter, dtype=dtype, device=dev) - noise, mv)
    if batched:
        kun = pred.assemble_cross_tiles_batched(uc, xc, params, mv, nv, kernel=kernel, batch_dispatch=bd)
    else:
        kun = pred.assemble_cross_tiles(uc, xc, params, mv, nv, kernel=kernel)  # (MU, M, m, m)
    c = executor.run_lowrank_contraction(kun, yc, n_streams=n_streams, device=dev)
    luu = executor.run_cholesky(
        kuu, n_streams=n_streams, update_dtype=update_dtype, batch_dispatch=bd, device=dev
    )
    del kuu
    # whitened cross grid W = L_uu^-1 K_un, then B = I + s^-2 W W^T
    w = executor.run_solve(luu, kun, lower=True, n_streams=n_streams, device=dev)
    del kun
    c_w = executor.run_lowrank_contraction(w, yc, n_streams=n_streams, device=dev)
    gram = _gram_packed(w)
    del w
    b_packed = _packed_eye(mu_tiles, tile_size, dtype, dev) + _lift(1.0 / noise, 3) * gram
    lb = executor.run_cholesky(
        b_packed, n_streams=n_streams, update_dtype=update_dtype, batch_dispatch=bd, device=dev
    )
    return LowRankState(
        u_chunks=uc, luu_packed=luu, b_packed=b_packed, lb_packed=lb, c_chunks=c,
        gamma=_inner_solve(luu, lb, c_w, n_streams, dev), c_w=c_w,
        yty=_masked_yty(yc, nv), n=n, m=tile_size, m_inducing=m_inducing,
        params=params, jitter=float(jitter), mu_valid=mu_valid,
        n_valid=n_valid if isinstance(n_valid, torch.Tensor) else None, kernel=kernel,
    )


# ---------------------------------------------------------------------------
# Streaming absorption (rank-m update; O(b m^2 + m^3), never O(n^3)).
# ---------------------------------------------------------------------------


def absorb(
    state: LowRankState,
    x_new,
    y_new,
    counts=None,
    *,
    sign: int = 1,
    n_streams: Optional[int] = None,
    update_dtype=None,
    batch_dispatch: str = "flat",
) -> LowRankState:
    """Absorb (``sign=+1``) or forget (``sign=-1``) a block of training rows.

    The inducing set stays fixed; only the inner system B, the projections
    c = K_un y and c_w = W y and the counters change.  One ``cov_tiles``,
    two ``lrgemm`` and the tiled Cholesky of B on the card.  A stacked state
    takes (B, b, D) / (B, b); ``counts`` ((B,), or an int) marks a ragged
    block whose problem i brings only its first ``counts[i]`` rows: the rest
    are a column frontier of K_ub, so they add nothing to B, c or y^T y,
    and a ragged state's ``n_valid`` moves by ``counts``.  Raises
    :class:`repro_torch.core.update.CholeskyUpdateError` when the refreshed
    factor goes non-finite (``sign=-1`` can remove more than the inner
    system holds); callers rebuild cold.  ``state`` is not modified.
    """
    dev, dtype, kernel = state.device, state.c_chunks.dtype, state.kernel
    batched = state.c_chunks.ndim == 3
    x_new = torch.as_tensor(x_new, device=dev).to(dtype)
    y_new = torch.as_tensor(y_new, device=dev).to(dtype)
    y_new = y_new.reshape(y_new.shape[0], -1) if batched else y_new.reshape(-1)
    b = x_new.shape[-2]
    if counts is None:
        cnt = b
    else:
        cnt = pred._valid(counts, dev) if batched else int(counts)
    xbc = tiling.pad_features(x_new, state.m)
    ybc = tiling.pad_vector(y_new, state.m)
    if batched:
        kub = pred.assemble_cross_tiles_batched(
            state.u_chunks, xbc, state.params, _mu_valid(state), cnt, kernel=kernel,
            batch_dispatch=batch_dispatch,
        )
    else:
        kub = pred.assemble_cross_tiles(
            state.u_chunks, xbc, state.params, _mu_valid(state), cnt, kernel=kernel
        )
    dc = executor.run_lowrank_contraction(kub, ybc, n_streams=n_streams, device=dev)
    # whitened block W_b = L_uu^-1 K_ub; the inducing factor never changes
    wb = executor.run_solve(state.luu_packed, kub, lower=True, n_streams=n_streams, device=dev)
    dc_w = executor.run_lowrank_contraction(wb, ybc, n_streams=n_streams, device=dev)
    s = torch.as_tensor(float(sign), dtype=dtype, device=dev)
    inv_noise = _lift(1.0 / _noise(kernel, state.params, ybc), 3)
    b_packed = state.b_packed + s * inv_noise * _gram_packed(wb)
    c = state.c_chunks + s * dc
    lb = executor.run_cholesky(
        b_packed, n_streams=n_streams, update_dtype=update_dtype, batch_dispatch=batch_dispatch, device=dev
    )
    upd._check(lb, "low-rank inner-system refactorization")
    c_w = state.c_w + s * dc_w
    nv = state.n_valid
    if nv is not None:
        nv = nv + sign * (cnt.to(nv.dtype) if isinstance(cnt, torch.Tensor) else cnt)
    return dataclasses.replace(
        state, b_packed=b_packed, lb_packed=lb, c_chunks=c,
        gamma=_inner_solve(state.luu_packed, lb, c_w, n_streams, dev), c_w=c_w,
        yty=state.yty + s * _masked_yty(ybc, cnt), n=state.n + sign * b, n_valid=nv,
    )


# ---------------------------------------------------------------------------
# Prediction head.
# ---------------------------------------------------------------------------


def predict_from_lowrank_state(
    state: LowRankState,
    x_test,
    *,
    full_cov: bool = False,
    n_streams: Optional[int] = None,
    dtype=None,
    nt_valid=None,
    batch_dispatch: str = "flat",
):
    """Posterior mean (and with ``full_cov`` the covariance) from a cached state.

    One ``cov_tiles`` (CROSS) and mean = s^-2 K_*u gamma; with ``full_cov``
    also the PRIOR grid, V1 = L_uu^-1 K_u* and V2 = L_B^-1 V1 by tiled matrix
    solves, and two Gram products.  The covariance's diagonal is clamped at
    zero, as the reference clamps it.  A stacked state takes (B, n̂, D), and
    ``nt_valid`` ((B,) or an int) the per-problem test counts: the rows past
    a problem's count are a row frontier of CROSS and PRIOR.  ``dtype``
    (default the state's) is the test points' dtype.
    """
    dev = state.device
    dtype = state.c_chunks.dtype if dtype is None else dtype
    batched = state.c_chunks.ndim == 3
    x_test = torch.as_tensor(x_test, device=dev).to(dtype)
    nt = x_test.shape[-2]
    if nt_valid is None:
        ntv = nt
    else:
        ntv = pred._valid(nt_valid, dev) if batched else int(nt_valid)
    xtc = tiling.pad_features(x_test, state.m)
    table = pred._table(state.params, state.kernel, xtc)
    if batched:
        kstar = pred.assemble_cross_tiles_batched(
            xtc, state.u_chunks, state.params, ntv, _mu_valid(state), kernel=state.kernel, table=table,
            batch_dispatch=batch_dispatch,
        )  # (B, Q, MU, m, m)
    else:
        kstar = pred.assemble_cross_tiles(
            xtc, state.u_chunks, state.params, ntv, _mu_valid(state), kernel=state.kernel, table=table
        )  # (Q, MU, m, m)
    inv_noise = _lift(1.0 / _noise(state.kernel, state.params, state.gamma), 2)
    mean = inv_noise * triangular.tiled_matvec(kstar, state.gamma)
    mean = mean.reshape(mean.shape[:-2] + (-1,))[..., :nt]
    if not full_cov:
        return mean
    # tile rows of K_u*: ((B,) MU, Q, m, m)
    v1 = executor.run_solve(
        state.luu_packed, kstar.transpose(-4, -3).transpose(-2, -1), lower=True, n_streams=n_streams,
        device=dev,
    )
    del kstar
    v2 = executor.run_solve(state.lb_packed, v1, lower=True, n_streams=n_streams, device=dev)
    if batched:
        covt = pred.assemble_prior_tiles_batched(
            xtc, state.params, ntv, kernel=state.kernel, table=table, batch_dispatch=batch_dispatch
        )
    else:
        covt = pred.assemble_prior_tiles(xtc, state.params, ntv, kernel=state.kernel, table=table)
    covt -= triangular.tiled_gram(v1)
    covt += triangular.tiled_gram(v2)
    cov = tiling.untile_dense(covt)
    del covt
    cov.diagonal(dim1=-2, dim2=-1).clamp_(min=0.0)
    return mean, cov[..., :nt, :nt]


def _woodbury_nlml(state: LowRankState, ctac: torch.Tensor, dtype=None) -> torch.Tensor:
    """0.5 [ s^-2 y^T y - s^-4 c^T A^-1 c + n log s^2 + log det B + n log 2 pi ], given c^T A^-1 c.

    n is each problem's own row count on a ragged state (``n_valid``)."""
    noise = _noise(state.kernel, state.params, state.c_chunks)
    inv = 1.0 / noise
    quad = inv * state.yty - inv * inv * ctac
    logdet_b = triangular.logdet_from_factor(state.lb_packed, state.u_chunks.shape[-3])
    if state.n_valid is None:
        nv = torch.as_tensor(float(state.n), dtype=noise.dtype, device=noise.device)
    else:
        nv = state.n_valid.to(noise.dtype)
    log2pi = torch.as_tensor(math.log(2.0 * math.pi), dtype=noise.dtype, device=noise.device)
    out = 0.5 * (quad + nv * torch.log(noise) + logdet_b + nv * log2pi)
    return out if dtype is None else out.to(dtype)


def nlml_from_lowrank_state(state: LowRankState, *, dtype=None) -> torch.Tensor:
    """Woodbury / matrix-determinant-lemma NLML from the cached pieces, the
    reference's formula: c^T A^-1 c = c . gamma (a state carried over from
    the JAX package holds the reference's c and gamma); in ``dtype``
    (default the state's)."""
    return _woodbury_nlml(state, triangular.problem_sums(state.c_chunks * state.gamma), dtype)


def whitened_nlml(state: LowRankState, *, dtype=None) -> torch.Tensor:
    """The same NLML with c^T A^-1 c = |L_B^-1 c_w|^2, in the whitened
    coordinates that gamma is solved in: the value that
    ``GaussianProcess.nlml()`` returns and
    :func:`repro_torch.core.mll.nlml_lowrank` trains.

    c . gamma pairs c = K_un y with a gamma solved from c_w = W y, and
    L_uu's conditioning amplifies their float32 disagreement, which this
    form does not have.
    """
    z = executor.run_solve(state.lb_packed, state.c_w, lower=True, device=state.device)
    return _woodbury_nlml(state, triangular.problem_sums(z * z), dtype)


def predict_lowrank(
    x,
    y,
    x_test,
    params,
    m_inducing: int,
    tile_size: int,
    *,
    strategy: str = "subset",
    inducing=None,
    jitter: float = DEFAULT_JITTER,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=torch.float32,
    kernel=None,
    device="cuda",
) -> torch.Tensor:
    """Cold low-rank predictive mean: state build, then the head."""
    state = lowrank_state(
        x, y, params, m_inducing, tile_size,
        strategy=strategy, inducing=inducing, jitter=jitter, n_streams=n_streams,
        update_dtype=update_dtype, dtype=dtype, kernel=kernel, device=device,
    )
    return predict_from_lowrank_state(state, x_test, n_streams=n_streams)
