"""Device-resident tiled GP prediction pipeline (paper Section 4), in PyTorch.

Pipeline:

  1. assemble packed training covariance  K = K_XX + sigma^2 I   (tiled)
  2. tiled Cholesky                       K = L L^T
  3. forward / backward substitution      L beta = y;  L^T alpha = beta
  4. cross covariance                     K_* = K_{X̂,X}          (tiled)
  5. predictive mean                      ŷ = K_* alpha
  6. (uncertainty) solve L V = K_{X,X̂};  W = V^T V;  Σ = K_{X̂,X̂} - W

Two execution strategies, as in the JAX package:

* :func:`predict_fused` (the default path): the whole pipeline is ONE
  multi-stage program; :func:`repro_torch.core.executor.run_program` walks
  the fused DAG over a named buffer environment, so substitution rows and
  cross-covariance tiles are issued as soon as their factor tiles resolve.
* :func:`predict_staged`: the six stages as separate executor invocations
  (the per-stage baseline the fused program is compared against).

:func:`predict_monolithic` is the dense baseline the paper compares against
(``torch.linalg.cholesky``, i.e. cuSOLVER on the card).

Padding: inputs of any n / n̂ are padded to tile multiples; the padded
covariance region is identity/zero, which leaves the results for the first
n (resp. n̂) entries unchanged.  Every entry point takes ``device=``
(default ``"cuda"``) and raises when CUDA is asked for and absent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import cholesky as chol
from repro_torch.core import executor
from repro_torch.core import kernels_math as km
from repro_torch.core import tiling, triangular
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Tiled covariance assembly (one cov_tiles launch per call).
# ---------------------------------------------------------------------------


def _offsets(idx: torch.Tensor, m: int) -> torch.Tensor:
    return idx.to(torch.int32) * m


def assemble_packed_covariance(x_chunks, params, n_valid: int, *, kernel=None) -> torch.Tensor:
    """(M, m, D) padded feature chunks -> packed lower covariance tiles (T, m, m)."""
    m_tiles, m, _ = x_chunks.shape
    rows, cols = (
        torch.from_numpy(a).to(x_chunks.device) for a in tiling._packed_coords(m_tiles)
    )
    return ops.cov_tiles(
        x_chunks[rows], x_chunks[cols], _offsets(rows, m), _offsets(cols, m),
        n_valid, n_valid, params, symmetric=True, kernel=kernel,
    )


def _grid(xa_chunks, xb_chunks, params, nvr: int, nvc: int, kernel) -> torch.Tensor:
    """Tile grid (P, Q, m, m) of K(xa, xb) with padded rows/cols zero."""
    p, m, _ = xa_chunks.shape
    q = xb_chunks.shape[0]
    dev = xa_chunks.device
    rows = torch.arange(p, device=dev).repeat_interleave(q)
    cols = torch.arange(q, device=dev).repeat(p)
    flat = ops.cov_tiles(
        xa_chunks[rows], xb_chunks[cols], _offsets(rows, m), _offsets(cols, m),
        nvr, nvc, params, symmetric=False, kernel=kernel,
    )
    return flat.reshape(p, q, m, m)


def assemble_cross_tiles(xt_chunks, x_chunks, params, nt_valid: int, n_valid: int, *, kernel=None):
    """K_{X̂,X} tile grid (Q, M, m, m) from (Q, m, D) x (M, m, D)."""
    return _grid(xt_chunks, x_chunks, params, nt_valid, n_valid, kernel)


def assemble_prior_tiles(xt_chunks, params, nt_valid: int, *, kernel=None):
    """Prior K_{X̂,X̂} tile grid (Q, Q, m, m), no noise, padded region 0."""
    return _grid(xt_chunks, xt_chunks, params, nt_valid, nt_valid, kernel)


def _resolve_dtype(dtype, x) -> torch.dtype:
    """``dtype=None`` keeps the input's floating dtype."""
    if dtype is not None:
        return dtype
    return torch.as_tensor(x).dtype


def _prepare(x_train, y_train, x_test, m: int, dtype, dev: torch.device):
    """Padded chunks (xc, yc, xtc) on ``dev``; x_test may be None."""
    dtype = _resolve_dtype(dtype, x_train)
    xc = tiling.pad_features(torch.as_tensor(x_train, device=dev), m, dtype=dtype)
    yc = tiling.pad_vector(torch.as_tensor(y_train, device=dev), m, dtype=dtype)
    xtc = None
    if x_test is not None:
        xtc = tiling.pad_features(torch.as_tensor(x_test, device=dev), m, dtype=dtype)
    return xc, yc, xtc


# ---------------------------------------------------------------------------
# End-to-end tiled prediction.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PosteriorState:
    """Cached per-training-set state: the packed factor and the weight vector.

    Everything a repeated ``predict`` needs that does not depend on x_test;
    re-using it skips assembly, the factorization and both substitutions
    (the O(n^3) part).  All tensors live on one device.

    The state is live: :meth:`extend` absorbs new observations in O(n^2 b)
    by a block Cholesky append and :meth:`shrink` evicts the oldest ones by
    tiled rank updates, each returning a new state and leaving this one
    unchanged.  ``beta``/``y_chunks`` carry what the incremental maintenance
    needs; a state without them gets them from the factor on demand.
    """

    lpacked: torch.Tensor    # (T, m, m) packed Cholesky factor of K
    alpha: torch.Tensor      # (M, m) chunks of K^{-1} y
    x_chunks: torch.Tensor   # (M, m, D) padded training features
    n: int                   # valid training rows
    m: int                   # tile size
    params: object           # hyperparameters the factor was built with
    beta: Optional[torch.Tensor] = None      # (M, m) forward-solve chunks L^{-1} y
    y_chunks: Optional[torch.Tensor] = None  # (M, m) padded training targets
    # the covariance family the factor was assembled with; it travels with
    # the state so a warm prediction can never mix kernels
    kernel: km.Kernel = km.SQUARED_EXPONENTIAL

    @property
    def device(self) -> torch.device:
        return self.lpacked.device

    def extend(self, x_new, y_new, **kwargs) -> "PosteriorState":
        """Absorb new observations in O(n^2 b) (block Cholesky append).

        Keyword arguments go to :func:`repro_torch.core.update.extend_state`
        (``n_streams``, ``update_dtype``).  Raises
        :class:`repro_torch.core.update.CholeskyUpdateError` on numerical
        failure; callers fall back to a fresh :func:`posterior_state`.
        """
        from repro_torch.core import update as upd  # update imports this module

        return upd.extend_state(self, x_new, y_new, **kwargs)

    def shrink(self, k: int, **kwargs) -> "PosteriorState":
        """Evict the k oldest observations in O(n^2 k) (tiled rank update).

        ``k`` must be a multiple of the tile size (whole leading
        tile-columns); see :func:`repro_torch.core.update.shrink_state`.
        """
        from repro_torch.core import update as upd

        return upd.shrink_state(self, k, **kwargs)


def posterior_state(
    x_train,
    y_train,
    params,
    m: int,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=None,
    kernel=None,
    device="cuda",
) -> PosteriorState:
    """Assemble + factor K and solve for alpha = K^{-1} y (the cacheable part)."""
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    n = x_train.shape[0]
    xc, yc, _ = _prepare(x_train, y_train, None, m, dtype, dev)
    packed = assemble_packed_covariance(xc, params, n, kernel=kernel)
    lpacked = chol.tiled_cholesky(
        packed, n_streams=n_streams, update_dtype=update_dtype, device=dev
    )
    beta = triangular.forward_substitution(lpacked, yc, n_streams=n_streams, device=dev)
    alpha = triangular.backward_substitution(lpacked, beta, n_streams=n_streams, device=dev)
    return PosteriorState(
        lpacked=lpacked, alpha=alpha, x_chunks=xc, n=n, m=m, params=params,
        beta=beta, y_chunks=yc, kernel=kernel,
    )


def predict_from_state(
    state: PosteriorState,
    x_test,
    *,
    full_cov: bool = False,
    n_streams: Optional[int] = None,
):
    """Prediction given a (possibly cached) :class:`PosteriorState`.

    Hyperparameters and kernel come from the state (alpha and the factor
    are only valid for them), and so do the device and the dtype.
    """
    params, kernel, m = state.params, state.kernel, state.m
    dev = state.device
    nh = x_test.shape[0]
    xtc = tiling.pad_features(
        torch.as_tensor(x_test, device=dev), m, dtype=state.x_chunks.dtype
    )
    kstar = assemble_cross_tiles(xtc, state.x_chunks, params, nh, state.n, kernel=kernel)
    mean = triangular.tiled_matvec(kstar, state.alpha).reshape(-1)[:nh]
    if not full_cov:
        return mean
    # L V = K_{X,X̂}: the right-hand-side tiles are the transposed K_* grid.
    b_tiles = kstar.permute(1, 0, 3, 2)
    v = triangular.forward_substitution_matrix(
        state.lpacked, b_tiles, n_streams=n_streams, device=dev
    )
    w = triangular.tiled_gram(v)                                  # (Q, Q, m, m)
    prior = assemble_prior_tiles(xtc, params, nh, kernel=kernel)
    sigma = tiling.untile_dense(prior - w)[:nh, :nh]
    return mean, sigma


def predict_fused(
    x_train,
    y_train,
    x_test,
    params,
    m: int,
    *,
    full_cov: bool = False,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=None,
    with_state: bool = False,
    kernel=None,
    device="cuda",
):
    """Whole-pipeline fused prediction: one program over one buffer env.

    Returns the mean (or ``(mean, sigma)`` with ``full_cov``); with
    ``with_state=True`` also the :class:`PosteriorState` sliced out of the
    program's buffers, so later predictions can reuse the factor.
    """
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    n, nh = x_train.shape[0], x_test.shape[0]
    xc, yc, xtc = _prepare(x_train, y_train, x_test, m, dtype, dev)
    env = executor.run_program(
        xc, yc, xtc, params, n, nh,
        uncertainty=full_cov, n_streams=n_streams, update_dtype=update_dtype,
        kernel=kernel, device=dev,
    )
    mean = env["mean"].reshape(-1)[:nh]
    if full_cov:
        q_tiles = xtc.shape[0]
        sigma_tiles = env["prior"].view(q_tiles, q_tiles, m, m)
        result = (mean, tiling.untile_dense(sigma_tiles)[:nh, :nh])
    else:
        result = mean
    if not with_state:
        return result
    # env["y"] holds beta after the in-place forward substitution
    state = PosteriorState(
        lpacked=env["packed"], alpha=env["alpha"], x_chunks=xc, n=n, m=m,
        params=params, beta=env["y"], y_chunks=yc, kernel=kernel,
    )
    return result, state


def nlml_program_env(
    x_train,
    y_train,
    params,
    m: int,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=None,
    kernel=None,
    device="cuda",
):
    """Run the NLML prefix of the fused program: the prediction program with zero test tiles.

    ``q_tiles = 0`` reduces the whole-pipeline DAG to assembly, the
    factorization and both substitutions.  Returns ``(env, yc)``: the
    buffer environment, whose ``packed`` is the factor (log-determinant
    head) and ``alpha`` the weight chunks (quadratic-term head,
    ``sum(yc * env["alpha"])``), and the padded target chunks ``yc``.
    Differentiable by autograd: the buffers are written in place by
    ``index_copy_``/``index_add_``, and the tile ops keep their gradients
    (:mod:`repro_torch.kernels.ops`).
    """
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    n = x_train.shape[-2]
    xc, yc, _ = _prepare(x_train, y_train, None, m, dtype, dev)
    xtc = xc.new_zeros((0, m, xc.shape[-1]))
    env = executor.run_program(
        xc, yc, xtc, params, n, 0,
        n_streams=n_streams, update_dtype=update_dtype, kernel=kernel, device=dev,
    )
    return env, yc


def predict(x_train, y_train, x_test, params, m: int, **kwargs):
    """Tiled GP prediction: the fused whole-pipeline program (see predict_fused)."""
    return predict_fused(x_train, y_train, x_test, params, m, **kwargs)


def predict_staged(
    x_train,
    y_train,
    x_test,
    params,
    m: int,
    *,
    full_cov: bool = False,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=None,
    kernel=None,
    device="cuda",
):
    """The staged per-stage baseline: posterior state, then the prediction tail."""
    state = posterior_state(
        x_train, y_train, params, m,
        n_streams=n_streams, update_dtype=update_dtype, dtype=dtype,
        kernel=kernel, device=device,
    )
    return predict_from_state(state, x_test, full_cov=full_cov, n_streams=n_streams)


def predict_monolithic(
    x_train,
    y_train,
    x_test,
    params,
    *,
    full_cov: bool = False,
    dtype=None,
    kernel=None,
    device="cuda",
):
    """Dense baseline pipeline: one ``torch.linalg.cholesky`` (cuSOLVER) call."""
    dev = resolve_device(device)
    dtype = _resolve_dtype(dtype, x_train)
    x = torch.as_tensor(x_train, device=dev).to(dtype)
    y = torch.as_tensor(y_train, device=dev).to(dtype)
    xt = torch.as_tensor(x_test, device=dev).to(dtype)
    k = km.assemble_covariance(x, params, kernel=kernel)
    l = chol.monolithic_cholesky(k)
    beta = torch.linalg.solve_triangular(l, y[:, None], upper=False)
    alpha = torch.linalg.solve_triangular(l.mT, beta, upper=True)[:, 0]
    kstar = km.assemble_cross_covariance(xt, x, params, kernel=kernel)
    mean = kstar @ alpha
    if not full_cov:
        return mean
    v = torch.linalg.solve_triangular(l, kstar.mT, upper=False)
    prior = km.assemble_prior_covariance(xt, params, kernel=kernel)
    return mean, prior - v.mT @ v
