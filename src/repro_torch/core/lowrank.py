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
reference's.

:func:`absorb` adds (``sign=+1``) or removes (``sign=-1``) a block of
training rows through the rank-m inner system in O(b m^2 + m^3); the
inducing set stays fixed.  A removal that leaves B indefinite raises
:class:`repro_torch.core.update.CholeskyUpdateError`.

The plain products of the JAX package (the Gram of W, the head's mean and
covariance contractions) stay ``torch.matmul``/``torch.einsum``, with TF32
off on the card.  The problem axis B, ragged ``n_valid``, the Woodbury
NLML's gradient and training come with later slices;
:func:`nlml_from_lowrank_state` is the value only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def _subset_indices(mu: int, nv: int, device) -> torch.Tensor:
    """Strided subset indices: distinct for the first min(mu, nv) rows even
    when nv < mu (the tail repeats the last point)."""
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
    kmeans_iters: int = 4,
) -> Tuple[torch.Tensor, Optional[int]]:
    """Pick inducing inputs u (m_inducing, D) from training inputs x (n, D).

    Returns ``(u, mu_valid)``: ``mu_valid`` is the count of distinct
    inducing points when it is below ``m_inducing`` (n < m_inducing), else
    None.  An explicit ``inducing`` set is taken as it is, in x's dtype and
    device.  u is detached: the inducing set is fixed data, not a parameter.
    """
    if inducing is not None:
        u = torch.as_tensor(inducing, device=x.device).to(x.dtype)
        if u.ndim != 2 or u.shape[-2] != m_inducing:
            raise ValueError(
                f"explicit inducing set has shape {tuple(u.shape)}, expected "
                f"(m_inducing={m_inducing}, D)"
            )
        return u.detach(), None
    nv = x.shape[-2]
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

    u_chunks: torch.Tensor    # (MU, m, D) padded inducing chunks
    luu_packed: torch.Tensor  # packed lower tiles of chol(K_uu + jitter I)
    b_packed: torch.Tensor    # packed lower tiles of B = I + s^-2 W W^T (unfactored)
    lb_packed: torch.Tensor   # packed lower tiles of chol(B)
    c_chunks: torch.Tensor    # (MU, m) tiled c = K_un y
    gamma: torch.Tensor       # (MU, m) tiled A^-1 c, solved as L_uu^-T B^-1 c_w
    c_w: torch.Tensor         # (MU, m) tiled W y (= L_uu^-1 c), contracted from W itself
    yty: torch.Tensor         # 0-d: y^T y
    n: int                    # training rows absorbed
    m: int                    # tile size
    m_inducing: int
    params: object
    jitter: float
    mu_valid: Optional[int] = None  # distinct inducing points, when < m_inducing
    kernel: km.Kernel = km.SQUARED_EXPONENTIAL

    @property
    def device(self) -> torch.device:
        return self.c_chunks.device


# ---------------------------------------------------------------------------
# Assembly helpers.
# ---------------------------------------------------------------------------


def _mu_valid(state: LowRankState) -> int:
    return state.m_inducing if state.mu_valid is None else state.mu_valid


def _noise(kernel, params, like: torch.Tensor) -> torch.Tensor:
    """The noise variance as a 0-d tensor of ``like``'s dtype and device."""
    return torch.as_tensor(kernel.noise(params), dtype=like.dtype, device=like.device)


def _retune_diag(packed, mu_tiles: int, m: int, delta, mu_valid: int) -> torch.Tensor:
    """Shift the valid diagonal of packed symmetric tiles by ``delta``, in place.

    Symmetric assembly pins the diagonal to diag + noise; the inner matrices
    want jitter instead, so the diagonal is corrected after assembly by
    delta = jitter - noise on rows < mu_valid (padding rows keep their
    identity pin).  Two roundings, as the reference makes them.
    """
    idx = torch.from_numpy(triangular._diag_slots(mu_tiles)).to(packed.device)
    diag = packed.index_select(0, idx)  # (MU, m, m)
    row = torch.arange(mu_tiles * m, device=packed.device).reshape(mu_tiles, m)
    shift = torch.where(row < mu_valid, delta, torch.zeros((), dtype=packed.dtype, device=packed.device))
    packed.index_copy_(0, idx, diag + torch.diag_embed(shift))
    return packed


def _packed_from_grid(grid: torch.Tensor, mu_tiles: int) -> torch.Tensor:
    """The lower-triangle tiles of a symmetric (MU, MU, m, m) grid, in packed order."""
    rows, cols = (torch.from_numpy(a).to(grid.device) for a in tiling._packed_coords(mu_tiles))
    return grid[rows, cols]


def _packed_eye(mu_tiles: int, m: int, dtype, device) -> torch.Tensor:
    """Packed lower tiles of the (MU m x MU m) identity."""
    rows, cols = tiling._packed_coords(mu_tiles)
    base = torch.zeros((len(rows), m, m), dtype=dtype, device=device)
    base[torch.from_numpy(rows == cols).to(device)] = torch.eye(m, dtype=dtype, device=device)
    return base


def _gram_packed(w: torch.Tensor) -> torch.Tensor:
    """Packed lower tiles of W W^T for a (MU, M, m, mb) tile grid W.

    ``einsum("pjac,qjbc->pqab", w, w)`` of the reference, written as one
    matrix product over a single (MU m, M mb) row-major copy of W, so the
    grid (2 GiB at gp_256k) is permuted once, not once per operand.
    """
    mu_tiles, n_tiles, m, mb = w.shape
    wf = w.permute(0, 2, 1, 3).reshape(mu_tiles * m, n_tiles * mb)
    gram = (wf @ wf.mT).reshape(mu_tiles, m, mu_tiles, m).permute(0, 2, 1, 3)
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
    kernel=None,
    device="cuda",
) -> LowRankState:
    """Build the Nystrom low-rank posterior state of x (n, D), y (n,).

    Launches on the card: two ``cov_tiles`` (K_uu and K_un), two ``lrgemm``
    (c = K_un y and c_w = W y) and the tiled Cholesky of K_uu and of B; the
    solves and the Gram of W are plain torch.  K_un and W are freed before
    B is factored.
    """
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    x = torch.as_tensor(x, device=dev).to(dtype)
    y = torch.as_tensor(y, device=dev).to(dtype).reshape(-1)
    if x.ndim != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"lowrank_state takes x (n, D) and y (n,); got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    n = x.shape[0]
    u, mu_valid = select_inducing(x, m_inducing, strategy=strategy, inducing=inducing)
    uc = tiling.pad_features(u, tile_size)
    xc = tiling.pad_features(x, tile_size)
    yc = tiling.pad_vector(y, tile_size)
    mv = m_inducing if mu_valid is None else mu_valid
    mu_tiles = uc.shape[0]
    noise = _noise(kernel, params, yc)

    kuu = pred.assemble_packed_covariance(uc, params, mv, kernel=kernel)
    kuu = _retune_diag(kuu, mu_tiles, tile_size, torch.as_tensor(jitter, dtype=dtype, device=dev) - noise, mv)
    kun = pred.assemble_cross_tiles(uc, xc, params, mv, n, kernel=kernel)  # (MU, M, m, m)
    c = executor.run_lowrank_contraction(kun, yc, n_streams=n_streams, device=dev)
    luu = executor.run_cholesky(kuu, n_streams=n_streams, update_dtype=update_dtype, device=dev)
    del kuu
    # whitened cross grid W = L_uu^-1 K_un, then B = I + s^-2 W W^T
    w = executor.run_solve(luu, kun, lower=True, n_streams=n_streams, device=dev)
    del kun
    c_w = executor.run_lowrank_contraction(w, yc, n_streams=n_streams, device=dev)
    gram = _gram_packed(w)
    del w
    b_packed = _packed_eye(mu_tiles, tile_size, dtype, dev) + (1.0 / noise) * gram
    lb = executor.run_cholesky(b_packed, n_streams=n_streams, update_dtype=update_dtype, device=dev)
    return LowRankState(
        u_chunks=uc, luu_packed=luu, b_packed=b_packed, lb_packed=lb, c_chunks=c,
        gamma=_inner_solve(luu, lb, c_w, n_streams, dev), c_w=c_w, yty=torch.sum(yc * yc), n=n,
        m=tile_size, m_inducing=m_inducing, params=params, jitter=float(jitter),
        mu_valid=mu_valid, kernel=kernel,
    )


# ---------------------------------------------------------------------------
# Streaming absorption (rank-m update; O(b m^2 + m^3), never O(n^3)).
# ---------------------------------------------------------------------------


def absorb(
    state: LowRankState,
    x_new,
    y_new,
    *,
    sign: int = 1,
    n_streams: Optional[int] = None,
    update_dtype=None,
) -> LowRankState:
    """Absorb (``sign=+1``) or forget (``sign=-1``) a block of training rows.

    The inducing set stays fixed; only the inner system B, the projections
    c = K_un y and c_w = W y and the counters change.  One ``cov_tiles``,
    two ``lrgemm`` and the tiled Cholesky of B on the card.  Raises
    :class:`repro_torch.core.update.CholeskyUpdateError` when the refreshed
    factor goes non-finite (``sign=-1`` can remove more than the inner
    system holds); callers rebuild cold.  ``state`` is not modified.
    """
    dev, dtype, kernel = state.device, state.c_chunks.dtype, state.kernel
    x_new = torch.as_tensor(x_new, device=dev).to(dtype)
    y_new = torch.as_tensor(y_new, device=dev).to(dtype).reshape(-1)
    b = x_new.shape[0]
    xbc = tiling.pad_features(x_new, state.m)
    ybc = tiling.pad_vector(y_new, state.m)
    kub = pred.assemble_cross_tiles(
        state.u_chunks, xbc, state.params, _mu_valid(state), b, kernel=kernel
    )
    dc = executor.run_lowrank_contraction(kub, ybc, n_streams=n_streams, device=dev)
    # whitened block W_b = L_uu^-1 K_ub; the inducing factor never changes
    wb = executor.run_solve(state.luu_packed, kub, lower=True, n_streams=n_streams, device=dev)
    dc_w = executor.run_lowrank_contraction(wb, ybc, n_streams=n_streams, device=dev)
    s = torch.as_tensor(float(sign), dtype=dtype, device=dev)
    b_packed = state.b_packed + s * (1.0 / _noise(kernel, state.params, ybc)) * _gram_packed(wb)
    c = state.c_chunks + s * dc
    lb = executor.run_cholesky(b_packed, n_streams=n_streams, update_dtype=update_dtype, device=dev)
    upd._check(lb, "low-rank inner-system refactorization")
    c_w = state.c_w + s * dc_w
    return dataclasses.replace(
        state, b_packed=b_packed, lb_packed=lb, c_chunks=c,
        gamma=_inner_solve(state.luu_packed, lb, c_w, n_streams, dev), c_w=c_w,
        yty=state.yty + s * torch.sum(ybc * ybc), n=state.n + sign * b,
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
):
    """Posterior mean (and with ``full_cov`` the covariance) from a cached state.

    One ``cov_tiles`` (CROSS) and mean = s^-2 K_*u gamma; with ``full_cov``
    also the PRIOR grid, V1 = L_uu^-1 K_u* and V2 = L_B^-1 V1 by tiled matrix
    solves, and two Gram products.  The covariance's diagonal is clamped at
    zero, as the reference clamps it.
    """
    dev, dtype = state.device, state.c_chunks.dtype
    x_test = torch.as_tensor(x_test, device=dev).to(dtype)
    nt = x_test.shape[0]
    xtc = tiling.pad_features(x_test, state.m)
    kstar = pred.assemble_cross_tiles(
        xtc, state.u_chunks, state.params, nt, _mu_valid(state), kernel=state.kernel
    )  # (Q, MU, m, m)
    inv_noise = 1.0 / _noise(state.kernel, state.params, state.gamma)
    mean = (inv_noise * triangular.tiled_matvec(kstar, state.gamma)).reshape(-1)[:nt]
    if not full_cov:
        return mean
    # tile rows of K_u*: (MU, Q, m, m)
    v1 = executor.run_solve(
        state.luu_packed, kstar.permute(1, 0, 3, 2), lower=True, n_streams=n_streams, device=dev
    )
    del kstar
    v2 = executor.run_solve(state.lb_packed, v1, lower=True, n_streams=n_streams, device=dev)
    covt = pred.assemble_prior_tiles(xtc, state.params, nt, kernel=state.kernel)
    covt -= triangular.tiled_gram(v1)
    covt += triangular.tiled_gram(v2)
    cov = tiling.untile_dense(covt)
    del covt
    cov.diagonal().clamp_(min=0.0)
    return mean, cov[:nt, :nt]


def nlml_from_lowrank_state(state: LowRankState) -> torch.Tensor:
    """Woodbury / matrix-determinant-lemma NLML from the cached pieces (value only):

        0.5 [ s^-2 y^T y - s^-4 c^T A^-1 c + n log s^2 + log det B + n log 2 pi ]
    """
    noise = _noise(state.kernel, state.params, state.c_chunks)
    inv = 1.0 / noise
    quad = inv * state.yty - inv * inv * torch.sum(state.c_chunks * state.gamma)
    logdet_b = triangular.logdet_from_factor(state.lb_packed, state.u_chunks.shape[0])
    nv = torch.as_tensor(float(state.n), dtype=noise.dtype, device=noise.device)
    log2pi = torch.as_tensor(math.log(2.0 * math.pi), dtype=noise.dtype, device=noise.device)
    return 0.5 * (quad + nv * torch.log(noise) + logdet_b + nv * log2pi)


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
