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

Fleets: :func:`predict_fused_batched`, :func:`predict_from_state_batched`
and :func:`nlml_program_env` take B stacked problems of one tile geometry
((B, n, D) inputs) through the same plans, every launch B times wider,
with shared or per-problem ((B,) leaves) hyperparameters, and per-problem
validity frontiers ``n_valid``/``nt_valid`` ((B,) int tensors) for the
ragged buckets of a fleet of different sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import repro_torch.obs as obs
from repro_torch.core import cholesky as chol
from repro_torch.core import executor
from repro_torch.core import kernels_math as km
from repro_torch.core import tiling, triangular
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as sh
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Tiled covariance assembly (one cov_tiles launch per call).
# ---------------------------------------------------------------------------


def _offsets(idx: torch.Tensor, m: int) -> torch.Tensor:
    return idx.to(torch.int32) * m


def assemble_packed_covariance(x_chunks, params, n_valid, *, kernel=None, batch_dispatch="flat") -> torch.Tensor:
    """((B,) M, m, D) padded feature chunks -> packed lower covariance tiles ((B,) T, m, m), in one launch."""
    m_tiles, m = x_chunks.shape[-3], x_chunks.shape[-2]
    rows, cols = (
        torch.from_numpy(a).to(x_chunks.device) for a in tiling._packed_coords(m_tiles)
    )
    if x_chunks.ndim == 4:
        fn = executor._cov_batch_fn_batched(params, n_valid, n_valid, True, kernel, None, batch_dispatch)
        return fn(x_chunks.index_select(1, rows), x_chunks.index_select(1, cols), _offsets(rows, m),
                  _offsets(cols, m))
    return ops.cov_tiles(
        x_chunks[rows], x_chunks[cols], _offsets(rows, m), _offsets(cols, m),
        n_valid, n_valid, params, symmetric=True, kernel=kernel,
    )


def _grid(xa_chunks, xb_chunks, params, nvr, nvc, kernel, table=None, batch_dispatch="flat") -> torch.Tensor:
    """Tile grid ((B,) P, Q, m, m) of K(xa, xb) with padded rows/cols zero, in one launch."""
    p, m = xa_chunks.shape[-3], xa_chunks.shape[-2]
    q = xb_chunks.shape[-3]
    dev = xa_chunks.device
    rows = torch.arange(p, device=dev).repeat_interleave(q)
    cols = torch.arange(q, device=dev).repeat(p)
    if xa_chunks.ndim == 4:  # B problems: one flat launch of B * P * Q tiles
        fn = executor._cov_batch_fn_batched(params, nvr, nvc, False, kernel, table, batch_dispatch)
        flat = fn(xa_chunks.index_select(1, rows), xb_chunks.index_select(1, cols), _offsets(rows, m),
                  _offsets(cols, m))
        return flat.reshape(xa_chunks.shape[0], p, q, m, m)
    flat = ops.cov_tiles(
        xa_chunks[rows], xb_chunks[cols], _offsets(rows, m), _offsets(cols, m),
        nvr, nvc, params, symmetric=False, kernel=kernel, table=table,
    )
    return flat.reshape(p, q, m, m)


def _table(params, kernel, chunks):
    """The cov_tiles descriptor of a call's launches (None on the CPU)."""
    return ops.cov_descriptor(km.resolve_kernel(kernel), params, chunks.shape[-1], chunks.dtype, chunks.device)


def assemble_cross_tiles(xt_chunks, x_chunks, params, nt_valid: int, n_valid: int, *, kernel=None, table=None):
    """K_{X̂,X} tile grid (Q, M, m, m) from (Q, m, D) x (M, m, D)."""
    return _grid(xt_chunks, x_chunks, params, nt_valid, n_valid, kernel, table)


def assemble_prior_tiles(xt_chunks, params, nt_valid: int, *, kernel=None, table=None):
    """Prior K_{X̂,X̂} tile grid (Q, Q, m, m), no noise, padded region 0."""
    return _grid(xt_chunks, xt_chunks, params, nt_valid, nt_valid, kernel, table)


def assemble_cross_tiles_batched(
    xt_chunks, x_chunks, params, nt_valid, n_valid, *, kernel=None, table=None, batch_dispatch="flat"
):
    """Problem-batched K_{X̂,X} grid (B, Q, M, m, m) from (B, Q, m, D) x (B, M, m, D).

    Shared or per-problem ((B,) leaves) params, and scalar or (B,) frontiers,
    all in ONE cov_tiles launch of B * Q * M tiles on the card; the
    reference sends per-problem params to its plain tile instead.
    """
    return _grid(xt_chunks, x_chunks, params, nt_valid, n_valid, kernel, table, batch_dispatch)


def assemble_prior_tiles_batched(xt_chunks, params, nt_valid, *, kernel=None, table=None, batch_dispatch="flat"):
    """Problem-batched prior K_{X̂,X̂} grid (B, Q, Q, m, m), in one launch."""
    return _grid(xt_chunks, xt_chunks, params, nt_valid, nt_valid, kernel, table, batch_dispatch)


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
    needs; a state without them gets them from the factor on demand.  A
    fleet's state stacks B problems: every tensor gains the leading B axis.
    """

    lpacked: torch.Tensor    # (T, m, m) packed Cholesky factor of K
    alpha: torch.Tensor      # (M, m) chunks of K^{-1} y
    x_chunks: torch.Tensor   # (M, m, D) padded training features
    n: int                   # valid training rows
    m: int                   # tile size
    params: object           # hyperparameters the factor was built with
    beta: Optional[torch.Tensor] = None      # (M, m) forward-solve chunks L^{-1} y
    y_chunks: Optional[torch.Tensor] = None  # (M, m) padded training targets
    # ragged stacked states only: per-problem validity frontiers (B,) int32;
    # each factor is identity past its frontier, and the heads mask with
    # these instead of ``n`` (then the bucket's capacity)
    n_valid: Optional[torch.Tensor] = None
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
    dtype=None,
):
    """Prediction given a (possibly cached) :class:`PosteriorState`.

    Hyperparameters and kernel come from the state (alpha and the factor
    are only valid for them), and so does the device.  The test points are
    padded in ``dtype`` (``None``: the state's storage type); the tail runs
    in the promotion of it and the state's type, the state's tensors cast
    up, as the reference's arrays promote.
    """
    params, kernel, m = state.params, state.kernel, state.m
    dev = state.device
    obs.inc("predict.warm_tail")
    nh = x_test.shape[0]
    store = state.x_chunks.dtype
    dtype = store if dtype is None else dtype
    work = torch.promote_types(dtype, store)
    xtc = tiling.pad_features(torch.as_tensor(x_test, device=dev), m, dtype=dtype).to(work)
    x_chunks, alpha = state.x_chunks.to(work), state.alpha.to(work)
    table = _table(params, kernel, xtc)
    kstar = assemble_cross_tiles(xtc, x_chunks, params, nh, state.n, kernel=kernel, table=table)
    mean = triangular.tiled_matvec(kstar, alpha).reshape(-1)[:nh]
    if not full_cov:
        return mean
    # L V = K_{X,X̂}: the right-hand-side tiles are the transposed K_* grid.
    b_tiles = kstar.permute(1, 0, 3, 2)
    v = triangular.forward_substitution_matrix(
        state.lpacked.to(work), b_tiles, n_streams=n_streams, device=dev
    )
    w = triangular.tiled_gram(v)                                  # (Q, Q, m, m)
    prior = assemble_prior_tiles(xtc, params, nh, kernel=kernel, table=table)
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


def predict_fused_batched(
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
    batch_dispatch: str = "flat",
    n_valid=None,
    nt_valid=None,
    kernel=None,
    device="cuda",
    mesh=None,
):
    """Fused prediction of B independent GPs in ONE problem-batched program.

    x_train (B, n, D) / y_train (B, n) / x_test (B, n̂, D) stacked problems
    of one shape; ``params`` leaves shared or (B,).  The same Plan as one
    problem's drives all B (the same launch count, every launch B times
    wider).  A ragged bucket passes ``n_valid``, the (B,) valid training
    counts of problems zero-padded to a shared capacity, and optionally
    ``nt_valid``, per-problem test counts (rows past a problem's count come
    back zero).  Returns mean (B, n̂), or ``(mean, sigma)`` with sigma
    (B, n̂, n̂); with ``with_state=True`` also the stacked PosteriorState.

    **Sharded fleets:** under a ``mesh`` (a ``DeviceMesh``) every rank passes
    the same global stacks, runs its own slice of B
    (:mod:`repro_torch.dist.sharding`), and gets the global result, gathered
    once; the state is the rank's slice.
    """
    coll.check_mesh(mesh, "predict_fused_batched")
    kernel = km.resolve_kernel(kernel)
    if mesh is not None:
        bg = x_train.shape[0]
        out = predict_fused_batched(
            *(sh.device_put_fleet(torch.as_tensor(a), mesh) for a in (x_train, y_train, x_test)),
            sh.local_params(params, mesh, bg, kernel), m, full_cov=full_cov, n_streams=n_streams,
            update_dtype=update_dtype, dtype=dtype, with_state=with_state, batch_dispatch=batch_dispatch,
            n_valid=sh.local_rows(n_valid, mesh, bg), nt_valid=sh.local_rows(nt_valid, mesh, bg),
            kernel=kernel, device=device,
        )
        if not with_state:
            return sh.gather_tree(out, mesh, bg)
        return sh.gather_tree(out[0], mesh, bg), out[1]
    dev = resolve_device(device)
    b, n, nh = x_train.shape[0], x_train.shape[1], x_test.shape[1]
    xc, yc, xtc = _prepare(x_train, y_train, x_test, m, dtype, dev)
    ragged = n_valid is not None
    nv = _valid(n_valid, dev) if ragged else n
    ntv = nh if nt_valid is None else _valid(nt_valid, dev)
    env = executor.run_program(
        xc, yc, xtc, params, nv, ntv,
        uncertainty=full_cov, n_streams=n_streams, update_dtype=update_dtype,
        batch_dispatch=batch_dispatch, kernel=kernel, device=dev,
    )
    mean = env["mean"].reshape(b, -1)[:, :nh]
    if full_cov:
        q_tiles = xtc.shape[1]
        sigma_tiles = env["prior"].view(b, q_tiles, q_tiles, m, m)
        result = (mean, tiling.untile_dense(sigma_tiles)[:, :nh, :nh])
    else:
        result = mean
    if not with_state:
        return result
    state = PosteriorState(
        lpacked=env["packed"], alpha=env["alpha"], x_chunks=xc, n=n, m=m, params=params,
        beta=env["y"], y_chunks=yc, n_valid=nv if ragged else None, kernel=kernel,
    )
    return result, state


def _valid(v, dev) -> torch.Tensor:
    """Per-problem counts as an int32 tensor on ``dev`` (a pinned copy from the host, no stream sync)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.int32)
    return km._to_device(torch.as_tensor(v, dtype=torch.int32), dev)


def predict_from_state_batched(
    state: PosteriorState,
    x_test,
    *,
    full_cov: bool = False,
    n_streams: Optional[int] = None,
    dtype=None,
    nt_valid=None,
    batch_dispatch: str = "flat",
    mesh=None,
):
    """Warm batched prediction from a stacked :class:`PosteriorState`.

    The state holds B factors and weights; x_test (B, n̂, D).  Runs only the
    cross covariance and the mean (and with ``full_cov`` the matrix solve
    tail) through the batched plans.  A ragged state (``state.n_valid``)
    masks the cross covariance at each problem's own frontier: the padded
    feature rows are zeros, and an unmasked K_* column against them would
    be k(x̂, 0) != 0 against a factor that is identity there.  ``nt_valid``
    (an int or (B,)) masks per-problem test counts.  Under a ``mesh`` the
    state is this rank's slice of the fleet and x_test (B, n̂, D) the global
    stack; the result is global, gathered once.
    """
    coll.check_mesh(mesh, "predict_from_state_batched")
    if mesh is not None:
        bg = x_test.shape[0]
        out = predict_from_state_batched(
            state, sh.device_put_fleet(x_test, mesh), full_cov=full_cov, n_streams=n_streams, dtype=dtype,
            nt_valid=sh.local_rows(nt_valid, mesh, bg), batch_dispatch=batch_dispatch,
        )
        return sh.gather_tree(out, mesh, bg)
    params, kernel, m = state.params, state.kernel, state.m
    dev = state.device
    obs.inc("predict.warm_tail_batched")
    b, nh = x_test.shape[0], x_test.shape[1]
    dtype = state.x_chunks.dtype if dtype is None else dtype
    xtc = tiling.pad_features(torch.as_tensor(x_test, device=dev), m, dtype=dtype)
    nv = state.n if state.n_valid is None else state.n_valid
    ntv = nh if nt_valid is None else _valid(nt_valid, dev)
    table = _table(params, kernel, xtc)
    kstar = assemble_cross_tiles_batched(
        xtc, state.x_chunks, params, ntv, nv, kernel=kernel, table=table, batch_dispatch=batch_dispatch
    )
    mean = triangular.tiled_matvec(kstar, state.alpha).reshape(b, -1)[:, :nh]
    if not full_cov:
        return mean
    # L V = K_{X,X̂}: the right-hand sides are each problem's transposed K_* grid
    v = triangular.forward_substitution_matrix(
        state.lpacked, kstar.permute(0, 2, 1, 4, 3), n_streams=n_streams, device=dev
    )
    del kstar
    prior = assemble_prior_tiles_batched(xtc, params, ntv, kernel=kernel, table=table, batch_dispatch=batch_dispatch)
    prior -= triangular.tiled_gram(v)
    return mean, tiling.untile_dense(prior)[:, :nh, :nh]


def nlml_program_env(
    x_train,
    y_train,
    params,
    m: int,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=None,
    batch_dispatch: str = "flat",
    n_valid=None,
    kernel=None,
    device="cuda",
    mesh=None,
):
    """Run the NLML prefix of the fused program: the prediction program with zero test tiles.

    ``q_tiles = 0`` reduces the whole-pipeline DAG to assembly, the
    factorization and both substitutions.  Returns ``(env, yc)``: the
    buffer environment, whose ``packed`` is the factor (log-determinant
    head) and ``alpha`` the weight chunks (quadratic-term head,
    ``sum(yc * env["alpha"])``), and the padded target chunks ``yc``.
    Differentiable by autograd: the buffers are written in place by
    ``index_copy_``/``index_add_``, and the tile ops keep their gradients
    (:mod:`repro_torch.kernels.ops`).  Batched x_train (B, n, D) /
    y_train (B, n) give B factors and weight chunks; a ragged bucket passes
    ``n_valid`` (B,).  Under a ``mesh`` the stacks are global and the
    environment (an internal state) holds this rank's slice of B.
    """
    coll.check_mesh(mesh, "nlml_program_env")
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    if mesh is not None and torch.as_tensor(x_train).ndim == 3:
        bg = x_train.shape[0]
        x_train, y_train = (sh.device_put_fleet(torch.as_tensor(a), mesh) for a in (x_train, y_train))
        params, n_valid = sh.local_params(params, mesh, bg, kernel), sh.local_rows(n_valid, mesh, bg)
    n = x_train.shape[-2]
    xc, yc, _ = _prepare(x_train, y_train, None, m, dtype, dev)
    xtc = xc.new_zeros(xc.shape[:-3] + (0, m, xc.shape[-1]))
    env = executor.run_program(
        xc, yc, xtc, params, n if n_valid is None else _valid(n_valid, dev), 0,
        n_streams=n_streams, update_dtype=update_dtype, batch_dispatch=batch_dispatch,
        kernel=kernel, device=dev, mesh=mesh,
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
    k = km.assemble_covariance(x, params, kernel=kernel, dtype=None)
    l = chol.monolithic_cholesky(k)
    beta = torch.linalg.solve_triangular(l, y[:, None], upper=False)
    alpha = torch.linalg.solve_triangular(l.mT, beta, upper=True)[:, 0]
    kstar = km.assemble_cross_covariance(xt, x, params, kernel=kernel, dtype=None)
    mean = kstar @ alpha
    if not full_cov:
        return mean
    v = torch.linalg.solve_triangular(l, kstar.mT, upper=False)
    prior = km.assemble_prior_covariance(xt, params, kernel=kernel, dtype=None)
    return mean, prior - v.mT @ v
