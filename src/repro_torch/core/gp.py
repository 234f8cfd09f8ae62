"""User-facing Gaussian-process API (GPRat-style), in PyTorch.

Construct with data and hyperparameters, then ``predict`` /
``predict_with_uncertainty`` / ``predict_full_cov``.

* ``pipeline="tiled"``      — the paper's tiled pipeline (default)
* ``pipeline="monolithic"`` — the dense ``torch.linalg.cholesky`` (cuSOLVER)
  baseline the paper compares against
* ``fused=True`` (default)  — cold predictions run the whole pipeline as ONE
  multi-stage program; ``fused=False`` is the staged per-stage baseline

On the card the tile ops launch the port's hand-written kernels; with
``device="cpu"`` they run the kernels' plain PyTorch versions.  There is no
backend switch and no fallback between the two.

The tiled pipeline caches its :class:`repro_torch.core.predict.PosteriorState`
(packed factor + alpha; with ``fused`` a slice of the fused program's
buffers) across ``predict`` calls.  The cache key holds the identity and
the in-place version counter of the training tensors, the hyperparameters
and every pipeline knob, so a change to any of them rebuilds the factor.

``update`` / ``forget`` / ``sliding_window`` keep the training set moving:
on a warm cache they extend or shrink the cached state in O(n^2 b) instead
of refactorizing; a cold cache, an unaligned ``forget`` or a numerical
failure (:class:`repro_torch.core.update.CholeskyUpdateError`) invalidates
the cache so that the next prediction refactorizes.

``nlml`` / ``log_marginal_likelihood`` read the cached state, and
``optimize`` fits the hyperparameters by Adam on the NLML of the GP's own
path (:mod:`repro_torch.core.mll`).

``method="lowrank"`` (with ``m_inducing``) runs the tiled Nystrom/DTC tier
of :mod:`repro_torch.core.lowrank` instead, and takes precedence over
``pipeline``/``fused``: an O(n m^2) cold build of an m-point inner system,
O(m^2) per test point, and ``update``/``forget`` through the rank-m inner
system for any row count (the sliding window evicts the exact excess).
Its state is cached in a slot of its own beside the exact one, under the
same key.

:class:`GPBatch` runs B independent GPs of one size as ONE problem-batched
program (every launch B times wider, the same plans as one GP), and
:class:`GPFleet` B GPs of different sizes, bucketed by tile geometry with
per-problem validity frontiers, on either tier; both keep the contract above.

Telemetry (:mod:`repro_torch.obs`, off by default): the cache counters
``cache.posterior.*``, ``cache.lowrank.*`` and ``cache.bucket.*`` (``cold``
on a build, ``warm`` on a hit), ``fleet.optimize``, and the health events
``refactorize_fallback`` (a failed warm update that leaves the cache cold,
with its ``site``) and ``lowrank_jitter_retry``.  Each records host values
only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

import repro_torch.obs as obs
from repro_torch.core import kernels_math as km
from repro_torch.core import lowrank
from repro_torch.core import mll
from repro_torch.core import predict as pred
from repro_torch.core import tiling
from repro_torch.core import update as upd
from repro_torch.device import resolve_device


def _params_key(params):
    """Hashable digest of a params tree (host bytes of each leaf, at any depth)."""
    return tuple(
        torch.as_tensor(leaf).detach().cpu().numpy().tobytes() for leaf in km.tree_leaves(params)
    )


def _lowrank_state_with_retry(build, base_jitter: float) -> lowrank.LowRankState:
    """Cold Nystrom build with escalating-jitter retries.

    ``chol(K_uu + jitter I)`` fails when the inducing set has duplicate or
    near-duplicate rows and the jitter is too small: the factors come back
    non-finite.  The build is retried with the jitter raised tenfold, at
    most twice.  The probe reads only the two packed inner factors on the
    host, once per cold build, never on the per-predict path; each retry is
    a ``health.lowrank_jitter_retry`` event.
    """
    jit = float(base_jitter)
    state = build(jit)
    for _ in range(2):
        if bool(torch.isfinite(state.luu_packed).all() & torch.isfinite(state.lb_packed).all()):
            return state
        jit = max(jit, lowrank.DEFAULT_JITTER) * 10.0
        obs.health_event("lowrank_jitter_retry", jitter=jit)
        state = build(jit)
    return state


@contextlib.contextmanager
def ieee_float32_matmul(device):
    """Keep float32 products in IEEE float32 on the card (no TF32) inside the block.

    GRAM, the cross-covariance matvecs and the solves go through cuBLAS and
    cuSOLVER; TF32 there would loosen the float32 parity with the JAX
    reference without any sign of it.  On a CUDA ``device`` this sets
    ``torch.backends.cuda.matmul.allow_tf32`` to False for the block and
    gives the caller's setting back on exit, also when the block raises.
    A caller who set the precision through the newer ``fp32_precision``
    API gets that setting back the same way.  The cuDNN flag is left alone:
    the GP uses no cuDNN.
    """
    if torch.device(device).type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    try:
        attr, ieee = "allow_tf32", False
        before = matmul.allow_tf32
    except RuntimeError:  # mixing the legacy flag with fp32_precision raises
        attr, ieee = "fp32_precision", "ieee"
        before = matmul.fp32_precision
    if before == ieee:
        yield
        return
    setattr(matmul, attr, ieee)
    try:
        yield
    finally:
        setattr(matmul, attr, before)


def _ieee_on_device(method):
    """Run a :class:`GaussianProcess` method under :func:`ieee_float32_matmul`."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with ieee_float32_matmul(self.device):
            return method(self, *args, **kwargs)

    return wrapped


@dataclasses.dataclass
class GaussianProcess:
    x_train: torch.Tensor
    y_train: torch.Tensor
    params: Optional[object] = None  # None -> kernel.default_params()
    tile_size: int = 256
    n_streams: Optional[int] = None
    pipeline: str = "tiled"
    update_dtype: Optional[torch.dtype] = None
    dtype: torch.dtype = torch.float32
    fused: bool = True
    sliding_window: Optional[int] = None  # keep at most n_max observations
    # covariance family: None / registry name / Kernel instance
    kernel: Optional[object] = None
    # approximation tier: "exact" factors the n x n covariance; "lowrank" the
    # m_inducing-point Nystrom inner system (takes precedence over pipeline/fused)
    method: str = "exact"
    device: object = "cuda"
    m_inducing: Optional[int] = None
    strategy: str = "subset"  # inducing selection: "subset" | "kmeans-lite"
    inducing: Optional[object] = None  # explicit inducing inputs (m_inducing, D)
    jitter: Optional[float] = None  # K_uu regularizer; None -> lowrank.DEFAULT_JITTER

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.kernel = km.resolve_kernel(self.kernel)
        if self.params is None:
            self.params = self.kernel.default_params()
        if self.method not in ("exact", "lowrank"):
            raise ValueError(f"method must be 'exact' or 'lowrank', got {self.method!r}")
        if self.method == "lowrank" and self.m_inducing is None:
            raise ValueError("method='lowrank' requires m_inducing")
        if self.pipeline not in ("tiled", "monolithic"):
            raise ValueError(
                f"pipeline must be 'tiled' or 'monolithic', got {self.pipeline!r}"
            )
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got {self.sliding_window}")
        # own copies: torch.as_tensor shares memory with a numpy array or tensor
        x = torch.as_tensor(self.x_train, device=self.device).to(self.dtype, copy=True)
        if x.ndim == 1:  # (n,) convenience for 1-D problems
            x = x[:, None]
        self.y_train = (
            torch.as_tensor(self.y_train, device=self.device).to(self.dtype, copy=True).reshape(-1)
        )
        n = self.y_train.shape[0]
        if x.ndim != 2 or x.shape[0] != n:
            raise ValueError(
                f"x_train must be (n, D) or (n,) with n == len(y_train) == {n}; "
                f"got shape {tuple(x.shape)}. Pass x_train.T explicitly if your "
                "features are stored (D, n) — it is not transposed silently."
            )
        self.x_train = x
        if self.inducing is not None:
            self.inducing = torch.as_tensor(self.inducing, device=self.device).to(self.dtype, copy=True)
        self._posterior: Optional[pred.PosteriorState] = None
        self._posterior_key = None
        self._lowrank: Optional[lowrank.LowRankState] = None
        self._lowrank_key = None

    # -- cached posterior ---------------------------------------------------

    def _cache_key(self):
        # tensors are mutable: identity plus the in-place version counter
        return (
            id(self.x_train),
            self.x_train._version,
            id(self.y_train),
            self.y_train._version,
            self.kernel,
            _params_key(self.params),
            self.tile_size,
            self.n_streams,
            str(self.update_dtype),
            str(self.dtype),
            self.method,
            self.m_inducing,
            self.strategy,
            None if self.jitter is None else float(self.jitter),
            None if self.inducing is None else (id(self.inducing), self.inducing._version),
        )

    def _cache_warm(self) -> bool:
        return self._posterior is not None and self._posterior_key == self._cache_key()

    @_ieee_on_device
    def posterior(self) -> pred.PosteriorState:
        """The packed Cholesky factor + alpha, cached across ``predict`` calls."""
        key = self._cache_key()
        if self._posterior is None or self._posterior_key != key:
            obs.inc("cache.posterior.cold")
            self._posterior = pred.posterior_state(
                self.x_train,
                self.y_train,
                self.params,
                self.tile_size,
                n_streams=self.n_streams,
                update_dtype=self.update_dtype,
                dtype=self.dtype,
                kernel=self.kernel,
                device=self.device,
            )
            self._posterior_key = key
        else:
            obs.inc("cache.posterior.warm")
        return self._posterior

    def _lowrank_warm(self) -> bool:
        return self._lowrank is not None and self._lowrank_key == self._cache_key()

    @_ieee_on_device
    def lowrank_posterior(self) -> lowrank.LowRankState:
        """The Nystrom state (``method="lowrank"``): inducing chunks, the
        whitened m x m inner factors and the projected weights, cached across
        ``predict`` calls under the same key as :meth:`posterior`."""
        key = self._cache_key()
        if self._lowrank is None or self._lowrank_key != key:
            obs.inc("cache.lowrank.cold")
            self._lowrank = _lowrank_state_with_retry(
                lambda jit: lowrank.lowrank_state(
                    self.x_train,
                    self.y_train,
                    self.params,
                    self.m_inducing,
                    self.tile_size,
                    strategy=self.strategy,
                    inducing=self.inducing,
                    jitter=jit,
                    n_streams=self.n_streams,
                    update_dtype=self.update_dtype,
                    dtype=self.dtype,
                    kernel=self.kernel,
                    device=self.device,
                ),
                lowrank.DEFAULT_JITTER if self.jitter is None else float(self.jitter),
            )
            self._lowrank_key = key
        else:
            obs.inc("cache.lowrank.warm")
        return self._lowrank

    def invalidate_cache(self) -> None:
        self._posterior = None
        self._posterior_key = None
        self._lowrank = None
        self._lowrank_key = None

    # -- streaming updates --------------------------------------------------

    @_ieee_on_device
    def update(self, x_new, y_new) -> "GaussianProcess":
        """Absorb new observations online in O(n^2 b), with no refactorization.

        Appends ``(x_new, y_new)`` to the training set.  On a warm cache the
        cached state is extended by the tiled block Cholesky append, so the
        next ``predict`` goes straight to the warm tail.  A cold cache, or a
        numerically failed append, invalidates the cache and the next
        prediction refactorizes.  With ``sliding_window=n_max`` the oldest
        observations are evicted (:meth:`forget`) once n exceeds n_max, in
        whole tiles, so that the eviction stays on the O(n^2) path.

        With ``method="lowrank"`` a warm state absorbs the rows through the
        rank-m inner system in O(b m^2 + m^3), and the sliding window evicts
        exactly the excess, since that downdate needs no tile alignment.
        """
        x_new = self._prep(x_new)
        y_new = torch.as_tensor(y_new, device=self.device).to(self.dtype).reshape(-1)
        if x_new.shape[0] != y_new.shape[0]:
            raise ValueError(
                f"update needs matching x_new (b, D) and y_new (b,); got "
                f"{tuple(x_new.shape)} and {tuple(y_new.shape)}"
            )
        if x_new.shape[0] == 0:
            return self
        if self.method == "lowrank":
            state = self._lowrank if self._lowrank_warm() else None
            self.x_train = torch.cat([self.x_train, x_new])
            self.y_train = torch.cat([self.y_train, y_new])
            self._absorb(state, x_new, y_new, sign=1)
            excess = 0 if self.sliding_window is None else self.y_train.shape[0] - self.sliding_window
            if excess > 0:
                self.forget(min(excess, self.y_train.shape[0] - 1))
            return self
        warm = self.pipeline == "tiled" and self._cache_warm()
        state = self._posterior
        self.x_train = torch.cat([self.x_train, x_new])
        self.y_train = torch.cat([self.y_train, y_new])
        if warm:
            try:
                self._posterior = state.extend(
                    x_new, y_new, n_streams=self.n_streams, update_dtype=self.update_dtype
                )
                self._posterior_key = self._cache_key()
            except upd.CholeskyUpdateError:
                obs.health_event("refactorize_fallback", site="gp.update")
                self.invalidate_cache()  # the next predict refactorizes
        else:
            self.invalidate_cache()
        if self.sliding_window is not None:
            excess = self.y_train.shape[0] - self.sliding_window
            if excess > 0:
                # evict whole tiles: round the overflow up to a tile multiple
                # (n stays <= n_max); a window under one tile evicts exactly
                m = self.tile_size
                self.forget(min(-(-excess // m) * m, self.y_train.shape[0] - 1))
        return self

    @_ieee_on_device
    def forget(self, k: int) -> "GaussianProcess":
        """Evict the k oldest observations (sliding-window downdate).

        A tile-aligned k on a warm cache runs the O(n^2 k) rank-update sweep
        (``PosteriorState.shrink``); anything else (unaligned k, cold cache,
        numerical failure) invalidates the cache, so the next prediction
        refactorizes the kept window.  With ``method="lowrank"`` a warm state
        forgets any k rows through the rank-m inner system.
        """
        n = self.y_train.shape[0]
        if not 0 <= k < n:
            raise ValueError(f"forget(k) needs 0 <= k < n = {n}; got {k}")
        if k == 0:
            return self
        if self.method == "lowrank":
            state = self._lowrank if self._lowrank_warm() else None
            x_old, y_old = self.x_train[:k], self.y_train[:k]
            self.x_train = self.x_train[k:]
            self.y_train = self.y_train[k:]
            self._absorb(state, x_old, y_old, sign=-1)
            return self
        warm = self.pipeline == "tiled" and self._cache_warm()
        state = self._posterior
        self.x_train = self.x_train[k:]
        self.y_train = self.y_train[k:]
        if warm and k % self.tile_size == 0:
            try:
                self._posterior = state.shrink(k, n_streams=self.n_streams)
                self._posterior_key = self._cache_key()
            except upd.CholeskyUpdateError:
                obs.health_event("refactorize_fallback", site="gp.forget")
                self.invalidate_cache()
        else:
            self.invalidate_cache()
        return self

    def _absorb(self, state: Optional[lowrank.LowRankState], x_rows, y_rows, *, sign: int) -> None:
        """Move a warm low-rank ``state`` by ``sign`` times the rows and cache
        it under the current key; no state, or a refactorization that fails,
        leaves the cache cold, so the next prediction rebuilds."""
        if state is None:
            self.invalidate_cache()
            return
        try:
            self._lowrank = lowrank.absorb(
                state, x_rows, y_rows, sign=sign,
                n_streams=self.n_streams, update_dtype=self.update_dtype,
            )
            self._lowrank_key = self._cache_key()
        except upd.CholeskyUpdateError:
            obs.health_event("refactorize_fallback", site="gp.update.lowrank" if sign > 0 else "gp.forget.lowrank")
            self.invalidate_cache()

    # -- prediction ---------------------------------------------------------

    def _predict_tiled(self, x_test: torch.Tensor, full_cov: bool):
        """Cached factor -> the staged tail; cold + ``fused`` -> one
        whole-pipeline program whose buffers also fill the posterior cache;
        cold staged -> posterior() then the tail."""
        key = self._cache_key()
        if self._posterior is not None and self._posterior_key == key:
            obs.inc("cache.posterior.warm")
            state = self._posterior
        elif self.fused:
            obs.inc("cache.posterior.cold")
            result, state = pred.predict_fused(
                self.x_train,
                self.y_train,
                x_test,
                self.params,
                self.tile_size,
                full_cov=full_cov,
                n_streams=self.n_streams,
                update_dtype=self.update_dtype,
                dtype=self.dtype,
                with_state=True,
                kernel=self.kernel,
                device=self.device,
            )
            self._posterior, self._posterior_key = state, key
            return result
        else:
            state = self.posterior()  # counts its own cold build
        return pred.predict_from_state(
            state, x_test, full_cov=full_cov, n_streams=self.n_streams
        )

    def _predict_monolithic(self, x_test: torch.Tensor, full_cov: bool):
        return pred.predict_monolithic(
            self.x_train, self.y_train, x_test, self.params,
            full_cov=full_cov, dtype=self.dtype, kernel=self.kernel, device=self.device,
        )

    def _predict_lowrank(self, x_test: torch.Tensor, full_cov: bool):
        return lowrank.predict_from_lowrank_state(
            self.lowrank_posterior(), x_test, full_cov=full_cov, n_streams=self.n_streams
        )

    @_ieee_on_device
    def predict(self, x_test) -> torch.Tensor:
        x_test = self._prep(x_test)
        if self.method == "lowrank":
            return self._predict_lowrank(x_test, full_cov=False)
        if self.pipeline == "monolithic":
            return self._predict_monolithic(x_test, full_cov=False)
        return self._predict_tiled(x_test, full_cov=False)

    @_ieee_on_device
    def predict_full_cov(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        """The paper's *Predict with Full Covariance Matrix* operation."""
        x_test = self._prep(x_test)
        if self.method == "lowrank":
            return self._predict_lowrank(x_test, full_cov=True)
        if self.pipeline == "monolithic":
            return self._predict_monolithic(x_test, full_cov=True)
        return self._predict_tiled(x_test, full_cov=True)

    @_ieee_on_device
    def predict_with_uncertainty(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, sigma = self.predict_full_cov(x_test)
        return mean, torch.diagonal(sigma)

    # -- hyperparameters ----------------------------------------------------

    @_ieee_on_device
    def nlml(self) -> torch.Tensor:
        """Negative log marginal likelihood from the cached state.

        Tiled: the quadratic term from the cached alpha chunks and the
        log-determinant from the packed factor's diagonal tiles, with no
        dense refactorization (:func:`mll.nlml_from_state`); low-rank: the
        Woodbury form of the cached Nystrom state in whitened coordinates
        (:func:`lowrank.whitened_nlml`, the value ``optimize`` trains);
        monolithic: the dense reference.
        """
        if self.method == "lowrank":
            return lowrank.whitened_nlml(self.lowrank_posterior())
        if self.pipeline == "monolithic":
            return mll.negative_log_marginal_likelihood(
                self.x_train, self.y_train, self.params, dtype=self.dtype, kernel=self.kernel,
                device=self.device,
            )
        return mll.nlml_from_state(self.posterior(), self.y_train, dtype=self.dtype)

    def log_marginal_likelihood(self) -> torch.Tensor:
        """``-nlml()``: on the tiled pipeline it reuses the cached posterior."""
        return -self.nlml()

    @_ieee_on_device
    def optimize(self, steps: int = 100, lr: float = 0.05, *, method: Optional[str] = None) -> "GaussianProcess":
        """Fit the hyperparameters by Adam on the NLML (:func:`mll.optimize_hyperparameters`).

        ``method`` defaults to the GP's own path: ``method="lowrank"`` trains
        the Nystrom NLML, ``pipeline="tiled"`` the tiled program (no dense
        Cholesky; the same tile_size, n_streams and update_dtype as
        prediction), ``pipeline="monolithic"`` the dense reference.  The
        cache is invalidated: the factor belongs to the old hyperparameters.
        """
        if method is None:
            if self.method == "lowrank":
                method = "lowrank"
            else:
                method = "tiled" if self.pipeline == "tiled" else "monolithic"
        self.params, _ = mll.optimize_hyperparameters(
            self.x_train, self.y_train, self.params, steps=steps, lr=lr, dtype=self.dtype,
            method=method, tile_size=self.tile_size, n_streams=self.n_streams,
            update_dtype=self.update_dtype, kernel=self.kernel, m_inducing=self.m_inducing,
            strategy=self.strategy, inducing=self.inducing, jitter=self.jitter, device=self.device,
        )
        self.invalidate_cache()
        return self

    def _prep(self, x_test) -> torch.Tensor:
        x_test = torch.as_tensor(x_test, device=self.device).to(self.dtype)
        if x_test.ndim == 1:
            x_test = x_test[:, None]
        return x_test


# ---------------------------------------------------------------------------
# Fleets: B independent GPs at once.
# ---------------------------------------------------------------------------


def _no_mesh(mesh, cls: str) -> None:
    if mesh is not None:
        raise NotImplementedError(f"{cls}(mesh=...): sharded fleets are not ported (ROADMAP.md queue 1, step 10)")


def _validate_fleet_params(params, kernel, b: int, cls: str) -> None:
    """Every hyperparameter leaf: its base shape (shared) or (B,) + base (per problem)."""
    base = km.tree_leaves(kernel.base_ndims(params))
    for i, (leaf, nd) in enumerate(zip(km.tree_leaves(params), base)):
        if km._ndim(leaf) > nd and leaf.shape[0] != b:
            raise ValueError(
                f"{cls} params leaf {i} must be shared (rank {nd}) or per-problem with leading "
                f"axis ({b},); got shape {tuple(leaf.shape)}"
            )


def _params_on(params, device):
    """The params tree with its tensor leaves on ``device`` (floats stay floats)."""
    return km.tree_map(
        lambda l: l.detach().to(device) if isinstance(l, torch.Tensor) else l, params
    )


class _FleetKey:
    """The params part of a fleet's cache key: host bytes of the leaves, memoized by each leaf's identity and version.

    The leaves of a trained fleet live on the card; reading them every call
    would synchronise the stream, so they are read again only when the tree's
    structure changes, a leaf is replaced, or a tensor leaf is written in place
    (its ``_version`` moves).  The memo holds the leaves themselves, so an
    identity it compares cannot be reused by a new tensor.
    """

    def __init__(self):
        self._memo = None

    @staticmethod
    def _same(a, b) -> bool:
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return a is b
        return type(a) is type(b) and a == b

    def __call__(self, params):
        leaves, treedef = km.tree_flatten(params)
        versions = [leaf._version if isinstance(leaf, torch.Tensor) else None for leaf in leaves]
        memo = self._memo
        if (memo is None or memo[1] != treedef or memo[2] != versions
                or not all(self._same(a, b) for a, b in zip(memo[0], leaves))):
            self._memo = memo = (leaves, treedef, versions, _params_key(params))
        return memo[3]


@dataclasses.dataclass
class GPBatch:
    """B independent GPs of one size, run as ONE problem-batched program.

    Stacked inputs: ``x_train`` (B, n, D) (or (B, n) for 1-D problems) and
    ``y_train`` (B, n): every problem shares n and D, so the whole fleet
    shares one executor Plan (a plan depends on the tile counts, never on
    B) and every launch covers the B problems' tiles.  ``params`` leaves
    are shared (the base shape) or per-problem ((B,) + base); on the card
    both go through the cov_tiles kernel, per-problem ones through its
    device table.  :meth:`optimize` returns (B,) leaves.

    The contract of :class:`GaussianProcess`: shapes are validated, the
    stacked :class:`repro_torch.core.predict.PosteriorState` is cached
    across calls under a key of the data, the hyperparameters and every
    knob, ``update``/``forget`` keep a warm cache warm, and the calls run
    under :func:`ieee_float32_matmul` on the card.  ``method="lowrank"``
    runs the fleet's Nystrom states as one batched build.
    ``batch_dispatch="vmap"`` launches once per problem (the reference's
    second mode).  ``mesh=`` is not ported.
    """

    x_train: torch.Tensor
    y_train: torch.Tensor
    params: Optional[object] = None  # None -> kernel.default_params()
    tile_size: int = 256
    n_streams: Optional[int] = None
    update_dtype: Optional[torch.dtype] = None
    dtype: torch.dtype = torch.float32
    batch_dispatch: str = "flat"
    mesh: Optional[object] = None
    kernel: Optional[object] = None
    method: str = "exact"
    device: object = "cuda"
    m_inducing: Optional[int] = None
    strategy: str = "subset"
    inducing: Optional[object] = None  # (m_inducing, D) shared or (B, m_inducing, D)
    jitter: Optional[float] = None

    def __post_init__(self):
        _no_mesh(self.mesh, "GPBatch")
        self.device = resolve_device(self.device)
        self.kernel = km.resolve_kernel(self.kernel)
        if self.params is None:
            self.params = self.kernel.default_params()
        if self.method not in ("exact", "lowrank"):
            raise ValueError(f"method must be 'exact' or 'lowrank', got {self.method!r}")
        if self.method == "lowrank" and self.m_inducing is None:
            raise ValueError("method='lowrank' requires m_inducing")
        if self.batch_dispatch not in ("flat", "vmap"):
            raise ValueError(f"batch_dispatch must be 'flat' or 'vmap', got {self.batch_dispatch!r}")
        x = torch.as_tensor(self.x_train, device=self.device).to(self.dtype, copy=True)
        if x.ndim == 2:  # (B, n) convenience for 1-D problems
            x = x[..., None]
        y = torch.as_tensor(self.y_train, device=self.device).to(self.dtype, copy=True)
        if x.ndim != 3 or y.ndim != 2 or x.shape[:2] != y.shape:
            raise ValueError(
                f"GPBatch needs stacked x_train (B, n, D) or (B, n) and y_train (B, n) with "
                f"matching leading axes; got x {tuple(x.shape)}, y {tuple(y.shape)}. Stack "
                "ragged problems to a common n, or use GPFleet (they are not padded silently)."
            )
        self.x_train, self.y_train = x, y
        _validate_fleet_params(self.params, self.kernel, x.shape[0], "GPBatch")
        self.params = _params_on(self.params, self.device)
        if self.inducing is not None:
            self.inducing = torch.as_tensor(self.inducing, device=self.device).to(self.dtype, copy=True)
        self._params_bytes = _FleetKey()
        self.invalidate_cache()

    @property
    def batch_size(self) -> int:
        return self.x_train.shape[0]

    # -- cached posterior ---------------------------------------------------

    def _cache_key(self):
        return (
            id(self.x_train), self.x_train._version, id(self.y_train), self.y_train._version,
            self.kernel, self._params_bytes(self.params), self.tile_size, self.n_streams,
            str(self.update_dtype), str(self.dtype), self.batch_dispatch, self.method,
            self.m_inducing, self.strategy, None if self.jitter is None else float(self.jitter),
            None if self.inducing is None else (id(self.inducing), self.inducing._version),
        )

    def invalidate_cache(self) -> None:
        self._posterior: Optional[pred.PosteriorState] = None
        self._posterior_key = None
        self._lowrank: Optional[lowrank.LowRankState] = None
        self._lowrank_key = None

    def _cache_warm(self) -> bool:
        return self._posterior is not None and self._posterior_key == self._cache_key()

    def _lowrank_warm(self) -> bool:
        return self._lowrank is not None and self._lowrank_key == self._cache_key()

    @_ieee_on_device
    def posterior(self) -> pred.PosteriorState:
        """The stacked factors and weights (leading B axis), cached across calls.

        The NLML prefix of the batched program (zero test tiles), so it
        shares every plan with prediction.
        """
        key = self._cache_key()
        if self._posterior is None or self._posterior_key != key:
            obs.inc("cache.posterior.cold")
            env, yc = pred.nlml_program_env(
                self.x_train, self.y_train, self.params, self.tile_size, n_streams=self.n_streams,
                update_dtype=self.update_dtype, dtype=self.dtype, batch_dispatch=self.batch_dispatch,
                kernel=self.kernel, device=self.device,
            )
            self._posterior = pred.PosteriorState(
                lpacked=env["packed"], alpha=env["alpha"],
                x_chunks=tiling.pad_features(self.x_train, self.tile_size, dtype=self.dtype),
                n=self.x_train.shape[1], m=self.tile_size, params=self.params, beta=env["y"],
                y_chunks=yc, kernel=self.kernel,
            )
            self._posterior_key = key
        else:
            obs.inc("cache.posterior.warm")
        return self._posterior

    @_ieee_on_device
    def lowrank_posterior(self) -> lowrank.LowRankState:
        """The stacked Nystrom states (leading B axis), cached across calls."""
        key = self._cache_key()
        if self._lowrank is None or self._lowrank_key != key:
            obs.inc("cache.lowrank.cold")
            self._lowrank = _lowrank_state_with_retry(
                lambda jit: lowrank.lowrank_state(
                    self.x_train, self.y_train, self.params, self.m_inducing, self.tile_size,
                    strategy=self.strategy, inducing=self.inducing, jitter=jit,
                    n_streams=self.n_streams, update_dtype=self.update_dtype, dtype=self.dtype,
                    batch_dispatch=self.batch_dispatch, kernel=self.kernel, device=self.device,
                ),
                lowrank.DEFAULT_JITTER if self.jitter is None else float(self.jitter),
            )
            self._lowrank_key = key
        else:
            obs.inc("cache.lowrank.warm")
        return self._lowrank

    # -- streaming updates --------------------------------------------------

    def _stacked_rows(self, x_new, y_new, what: str):
        x_new = torch.as_tensor(x_new, device=self.device).to(self.dtype)
        if x_new.ndim == 2 and self.x_train.shape[-1] == 1:
            x_new = x_new[..., None]
        y_new = torch.as_tensor(y_new, device=self.device).to(self.dtype)
        b = self.batch_size
        if x_new.ndim != 3 or x_new.shape[0] != b or x_new.shape[-1] != self.x_train.shape[-1] \
                or y_new.shape != x_new.shape[:-1]:
            raise ValueError(
                f"GPBatch.{what} needs stacked x (B, b, D) and y (B, b) with B == {b}; got x "
                f"{tuple(x_new.shape)}, y {tuple(y_new.shape)}"
            )
        return x_new, y_new

    @_ieee_on_device
    def update(self, x_new, y_new) -> "GPBatch":
        """Every problem absorbs b new points: x_new (B, b, D) (or (B, b)), y_new (B, b).

        One count b for the fleet keeps it on one tile geometry, so the
        append runs as ONE batched sweep.  A warm cache is extended in
        O(n^2 b); a cold cache, or a numerically failed append in any
        problem, invalidates it and the next call refactorizes the fleet.
        """
        x_new, y_new = self._stacked_rows(x_new, y_new, "update")
        if x_new.shape[1] == 0:
            return self
        state = self._warm_state()
        self.x_train = torch.cat([self.x_train, x_new], dim=1)
        self.y_train = torch.cat([self.y_train, y_new], dim=1)
        if self.method == "lowrank":
            self._move(state, "batch.update.lowrank", lambda st: lowrank.absorb(
                st, x_new, y_new, sign=1, n_streams=self.n_streams, update_dtype=self.update_dtype,
                batch_dispatch=self.batch_dispatch,
            ))
        else:
            self._move(state, "batch.update", lambda st: st.extend(
                x_new, y_new, n_streams=self.n_streams, update_dtype=self.update_dtype,
                batch_dispatch=self.batch_dispatch,
            ))
        return self

    @_ieee_on_device
    def forget(self, k: int) -> "GPBatch":
        """Evict every problem's k oldest observations (a fleet downdate).

        The exact tier stays warm for a tile-aligned k (the rank-update
        sweep, B problems a launch); any other k refactorizes on the next
        call.  The low-rank tier forgets any k through its inner systems.
        """
        n = self.y_train.shape[1]
        if not 0 <= k < n:
            raise ValueError(f"forget(k) needs 0 <= k < n = {n}; got {k}")
        if k == 0:
            return self
        state = self._warm_state()
        x_old, y_old = self.x_train[:, :k], self.y_train[:, :k]
        self.x_train, self.y_train = self.x_train[:, k:], self.y_train[:, k:]
        if self.method == "lowrank":
            self._move(state, "batch.forget.lowrank", lambda st: lowrank.absorb(
                st, x_old, y_old, sign=-1, n_streams=self.n_streams, update_dtype=self.update_dtype,
                batch_dispatch=self.batch_dispatch,
            ))
        elif k % self.tile_size == 0:
            self._move(state, "batch.forget",
                       lambda st: st.shrink(k, n_streams=self.n_streams, batch_dispatch=self.batch_dispatch))
        else:
            self.invalidate_cache()
        return self

    def _warm_state(self):
        """The tier's cached state if it is warm (the key of the current data and knobs), else None."""
        if self.method == "lowrank":
            return self._lowrank if self._lowrank_warm() else None
        return self._posterior if self._cache_warm() else None

    def _move(self, state, site: str, step) -> None:
        """Carry a warm ``state`` over a change of the data by ``step`` and cache it under the new
        key; no state, or a step that fails numerically (a ``refactorize_fallback`` at ``site``),
        leaves the cache cold."""
        self.invalidate_cache()
        if state is None:
            return
        try:
            state = step(state)
        except upd.CholeskyUpdateError:
            obs.health_event("refactorize_fallback", site=site)
            return
        if self.method == "lowrank":
            self._lowrank, self._lowrank_key = state, self._cache_key()
        else:
            self._posterior, self._posterior_key = state, self._cache_key()

    # -- prediction ---------------------------------------------------------

    def _predict(self, x_test, full_cov: bool):
        """Cold: ONE batched fused program, which also fills the cache; warm: the batched tail."""
        x_test = self._prep(x_test)
        if self.method == "lowrank":
            return lowrank.predict_from_lowrank_state(
                self.lowrank_posterior(), x_test, full_cov=full_cov, n_streams=self.n_streams,
                batch_dispatch=self.batch_dispatch,
            )
        key = self._cache_key()
        if self._posterior is not None and self._posterior_key == key:
            obs.inc("cache.posterior.warm")
            return pred.predict_from_state_batched(
                self._posterior, x_test, full_cov=full_cov, n_streams=self.n_streams,
                batch_dispatch=self.batch_dispatch,
            )
        obs.inc("cache.posterior.cold")
        result, state = pred.predict_fused_batched(
            self.x_train, self.y_train, x_test, self.params, self.tile_size, full_cov=full_cov,
            n_streams=self.n_streams, update_dtype=self.update_dtype, dtype=self.dtype,
            with_state=True, batch_dispatch=self.batch_dispatch, kernel=self.kernel, device=self.device,
        )
        self._posterior, self._posterior_key = state, key
        return result

    @_ieee_on_device
    def predict(self, x_test) -> torch.Tensor:
        """Means (B, n̂) for stacked (B, n̂, D) test points; a shared (n̂, D) block goes to every problem."""
        return self._predict(x_test, full_cov=False)

    @_ieee_on_device
    def predict_full_cov(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        """Means (B, n̂) and posterior covariances (B, n̂, n̂)."""
        return self._predict(x_test, full_cov=True)

    @_ieee_on_device
    def predict_with_uncertainty(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, sigma = self.predict_full_cov(x_test)
        return mean, torch.diagonal(sigma, dim1=-2, dim2=-1)

    # -- hyperparameters ----------------------------------------------------

    @_ieee_on_device
    def nlml(self) -> torch.Tensor:
        """The (B,) NLMLs from the cached stacked state (low-rank: whitened, as GaussianProcess)."""
        if self.method == "lowrank":
            return lowrank.whitened_nlml(self.lowrank_posterior())
        return mll.nlml_from_state(self.posterior(), self.y_train, dtype=self.dtype)

    def log_marginal_likelihood(self) -> torch.Tensor:
        return -self.nlml()

    @_ieee_on_device
    def optimize(self, steps: int = 100, lr: float = 0.05) -> "GPBatch":
        """Adam on the B NLMLs side by side, independent moments per problem
        (:func:`mll.optimize_hyperparameters_batched`); the leaves come back (B,)."""
        self.params, _ = mll.optimize_hyperparameters_batched(
            self.x_train, self.y_train, self.params, steps=steps, lr=lr, dtype=self.dtype,
            method="lowrank" if self.method == "lowrank" else "tiled", tile_size=self.tile_size,
            n_streams=self.n_streams, update_dtype=self.update_dtype, batch_dispatch=self.batch_dispatch,
            kernel=self.kernel, m_inducing=self.m_inducing, strategy=self.strategy,
            inducing=self.inducing if self.method == "lowrank" else None, jitter=self.jitter,
            device=self.device,
        )
        self.invalidate_cache()  # the factors belong to the old hyperparameters
        return self

    def _prep(self, x_test) -> torch.Tensor:
        """Test inputs as stacked (B, n̂, D).

        Accepted: (B, n̂, D) stacked; (n̂, D) shared by the fleet; (n̂,)
        shared 1-D points; and, for 1-D fleets only, (B, n̂) stacked
        per-problem points (when D == 1 and the leading axis equals B, a
        2-D input is read as stacked, the constructor's convention).
        """
        x_test = torch.as_tensor(x_test, device=self.device).to(self.dtype)
        d, b = self.x_train.shape[-1], self.batch_size
        if x_test.ndim == 1:
            x_test = x_test[:, None]
        if x_test.ndim == 2:
            if d == 1 and x_test.shape[0] == b:
                x_test = x_test[..., None]
            elif x_test.shape[-1] == d:
                x_test = x_test.expand((b,) + x_test.shape)
        if x_test.ndim != 3 or x_test.shape[0] != b or x_test.shape[-1] != d:
            raise ValueError(
                f"x_test must be (n̂, {d}) shared, (B, n̂, {d}) stacked"
                + (", (n̂,) shared or (B, n̂) stacked 1-D points" if d == 1 else "")
                + f" with B == {b}; got {tuple(x_test.shape)}"
            )
        return x_test


@dataclasses.dataclass
class _Bucket:
    """One bucket of a :class:`GPFleet`: problems that share a tile geometry."""

    idx: Tuple[int, ...]  # fleet indices, bucket order
    state: object         # stacked ragged state (a PosteriorState or a LowRankState) or None
    key: object           # fleet cache key at build time


def _index(idx, device) -> torch.Tensor:
    """Fleet indices as an int64 tensor on ``device``, by a pinned copy (no stream sync)."""
    return km._to_device(torch.tensor(list(idx), dtype=torch.int64), device)


def _padded_block(rows, idx) -> torch.Tensor:
    """The bucket's blocks ``rows[i]`` (i in ``idx``), zero-padded along their first axis to the longest, stacked."""
    b_max = max(rows[i].shape[0] for i in idx)
    return torch.stack([
        torch.nn.functional.pad(rows[i], (0, 0) * (rows[i].ndim - 1) + (0, b_max - rows[i].shape[0])) for i in idx
    ])


@dataclasses.dataclass
class GPFleet:
    """B independent GPs of different sizes, bucketed by tile geometry, on either tier.

    Problems are grouped into buckets whose tile-count capacities come from
    ``tiling.bucket_boundaries`` (powers of two by default), zero-padded to
    the capacity, and each bucket runs as ONE ragged problem-batched program
    with per-problem ``n_valid`` frontiers, (B,) int32 tensors on the
    device: one Plan per bucket geometry serves every mix of sizes.

    ``update`` absorbs ragged arrivals per bucket
    (:func:`repro_torch.core.update.extend_state_ragged`) and migrates the
    problems that outgrow their bucket: the factor is re-embedded into the
    larger geometry as ``blockdiag(L, I)`` (``tiling.embed_packed``, a
    gather) before the warm append, so migration never refactorizes.
    ``optimize`` fits each problem at its own size.

    ``method="lowrank"`` (with ``m_inducing``; ``strategy``, ``inducing``,
    a shared (m_inducing, D) set or a per-problem (B, m_inducing, D) one,
    and ``jitter`` as :class:`GaussianProcess` takes them) keeps a ragged
    Nystrom state per bucket (:func:`repro_torch.core.lowrank.lowrank_state`
    with ``n_valid``; each problem's ``mu_valid`` is its own).  That state is
    mu-sized, so a problem that changes bucket moves by a row gather of the
    warm state, then one ragged :func:`~repro_torch.core.lowrank.absorb` per
    destination bucket; K_uu is never factored again.  ``nlml`` is the
    whitened form of ``GPBatch``'s low-rank NLML.

    The contract of :class:`GPBatch`; leaves shared or (B,) (gathered per
    bucket).  ``mesh=`` is not ported.
    """

    x_train: Sequence            # length-B list of (n_i, D) or (n_i,) arrays
    y_train: Sequence            # length-B list of (n_i,) arrays
    params: Optional[object] = None
    tile_size: int = 64
    n_streams: Optional[int] = None
    update_dtype: Optional[torch.dtype] = None
    dtype: torch.dtype = torch.float32
    batch_dispatch: str = "flat"
    boundaries: object = tiling.DEFAULT_BUCKETS
    mesh: Optional[object] = None
    kernel: Optional[object] = None
    method: str = "exact"
    device: object = "cuda"
    m_inducing: Optional[int] = None
    strategy: str = "subset"
    inducing: Optional[object] = None  # (m_inducing, D) shared or (B, m_inducing, D)
    jitter: Optional[float] = None

    def __post_init__(self):
        _no_mesh(self.mesh, "GPFleet")
        if self.method not in ("exact", "lowrank"):
            raise ValueError(f"method must be 'exact' or 'lowrank', got {self.method!r}")
        if self.method == "lowrank" and self.m_inducing is None:
            raise ValueError("method='lowrank' requires m_inducing")
        if self.batch_dispatch not in ("flat", "vmap"):
            raise ValueError(f"batch_dispatch must be 'flat' or 'vmap', got {self.batch_dispatch!r}")
        self.device = resolve_device(self.device)
        self.kernel = km.resolve_kernel(self.kernel)
        if self.params is None:
            self.params = self.kernel.default_params()
        if len(self.x_train) != len(self.y_train) or not len(self.x_train):
            raise ValueError(
                f"GPFleet needs equal-length, non-empty x/y lists; got {len(self.x_train)} and "
                f"{len(self.y_train)}"
            )
        xs, ys, d = [], [], None
        for i, (x, y) in enumerate(zip(self.x_train, self.y_train)):
            x = torch.as_tensor(x, device=self.device).to(self.dtype, copy=True)
            if x.ndim == 1:
                x = x[:, None]
            y = torch.as_tensor(y, device=self.device).to(self.dtype, copy=True).reshape(-1)
            if x.ndim != 2 or x.shape[0] != y.shape[0] or y.shape[0] < 1:
                raise ValueError(
                    f"problem {i}: x must be (n, D) or (n,) with n == len(y) >= 1; got x "
                    f"{tuple(x.shape)}, y {tuple(y.shape)}"
                )
            if d is None:
                d = x.shape[1]
            elif x.shape[1] != d:
                raise ValueError(f"problem {i}: feature dim {x.shape[1]} != {d}: all fleet problems must share D")
            xs.append(x)
            ys.append(y)
        self._xs: List[torch.Tensor] = xs
        self._ys: List[torch.Tensor] = ys
        _validate_fleet_params(self.params, self.kernel, len(xs), "GPFleet")
        self.params = _params_on(self.params, self.device)
        if self.inducing is not None:
            ind = torch.as_tensor(self.inducing, device=self.device).to(self.dtype, copy=True)
            if ind.ndim not in (2, 3) or ind.shape[-2:] != (self.m_inducing, d) or (
                    ind.ndim == 3 and ind.shape[0] != len(xs)):
                raise ValueError(
                    f"GPFleet inducing must be ({self.m_inducing}, {d}) shared or "
                    f"({len(xs)}, {self.m_inducing}, {d}) per problem; got {tuple(ind.shape)}"
                )
            self.inducing = ind
        self._buckets: Dict[int, _Bucket] = {}
        self._version = 0
        self._params_bytes = _FleetKey()

    @property
    def batch_size(self) -> int:
        return len(self._xs)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(y.shape[0] for y in self._ys)

    def bucket_assignment(self) -> Dict[int, List[int]]:
        """The current ``{cap_tiles: [fleet indices]}`` map."""
        return tiling.bucket_problems(self.sizes, self.tile_size, self.boundaries)

    # -- cached per-bucket posteriors ---------------------------------------

    def _cache_key(self):
        bounds = tuple(self.boundaries) if isinstance(self.boundaries, (list, tuple)) else self.boundaries
        return (
            self._version, self.kernel, self._params_bytes(self.params), self.tile_size,
            self.n_streams, str(self.update_dtype), str(self.dtype), self.batch_dispatch, bounds,
            self.method, self.m_inducing, self.strategy, None if self.jitter is None else float(self.jitter),
            None if self.inducing is None else (id(self.inducing), self.inducing._version),
        )

    def invalidate_cache(self) -> None:
        self._buckets = {}

    def _bucket_params(self, idx):
        """Per-problem leaves gathered at the bucket's rows; shared leaves pass through."""
        return km.gather_params(self.params, _index(idx, self.device), self.kernel)

    def _stack(self, idx, cap_tiles):
        """The bucket's problems zero-padded to the capacity and stacked, and their (B,) sizes."""
        capn = cap_tiles * self.tile_size
        fpad = torch.nn.functional.pad
        xs = torch.stack([fpad(self._xs[i], (0, 0, 0, capn - self._xs[i].shape[0])) for i in idx])
        ys = torch.stack([fpad(self._ys[i], (0, capn - self._ys[i].shape[0])) for i in idx])
        nv = km._to_device(torch.tensor([self._ys[i].shape[0] for i in idx], dtype=torch.int32), self.device)
        return xs, ys, nv

    def _bucket_inducing(self, idx):
        """The explicit inducing set of the bucket's problems (shared stays (m, D)), or None."""
        if self.inducing is None or self.inducing.ndim == 2:
            return self.inducing
        return self.inducing.index_select(0, _index(idx, self.device))

    def _bucket_state(self, cap_tiles, idx):
        """The bucket's warm stacked state, built cold on a miss."""
        key = self._cache_key()
        rec = self._buckets.get(cap_tiles)
        if rec is not None and rec.key == key and rec.idx == tuple(idx) and rec.state is not None:
            obs.inc("cache.bucket.warm")
            return rec.state
        obs.inc("cache.bucket.cold")
        xs, ys, nv = self._stack(idx, cap_tiles)
        bp = self._bucket_params(idx)
        if self.method == "lowrank":
            ind = self._bucket_inducing(idx)
            state = _lowrank_state_with_retry(
                lambda jit: lowrank.lowrank_state(
                    xs, ys, bp, self.m_inducing, self.tile_size, strategy=self.strategy, inducing=ind,
                    jitter=jit, n_streams=self.n_streams, update_dtype=self.update_dtype, dtype=self.dtype,
                    batch_dispatch=self.batch_dispatch, n_valid=nv, kernel=self.kernel, device=self.device,
                ),
                lowrank.DEFAULT_JITTER if self.jitter is None else float(self.jitter),
            )
            self._buckets[cap_tiles] = _Bucket(tuple(idx), state, key)
            return state
        env, yc = pred.nlml_program_env(
            xs, ys, bp, self.tile_size, n_streams=self.n_streams, update_dtype=self.update_dtype,
            dtype=self.dtype, batch_dispatch=self.batch_dispatch, n_valid=nv, kernel=self.kernel,
            device=self.device,
        )
        state = pred.PosteriorState(
            lpacked=env["packed"], alpha=env["alpha"],
            x_chunks=tiling.pad_features(xs, self.tile_size, dtype=self.dtype),
            n=cap_tiles * self.tile_size, m=self.tile_size, params=bp, beta=env["y"],
            y_chunks=yc, n_valid=nv, kernel=self.kernel,
        )
        self._buckets[cap_tiles] = _Bucket(tuple(idx), state, key)
        return state

    def _predict_bucket(self, state, xt, full_cov: bool, nt_valid=None):
        """One bucket's batched warm head on its stacked test points, on the fleet's tier."""
        if self.method == "lowrank":
            return lowrank.predict_from_lowrank_state(
                state, xt, full_cov=full_cov, n_streams=self.n_streams, dtype=self.dtype,
                nt_valid=nt_valid, batch_dispatch=self.batch_dispatch,
            )
        return pred.predict_from_state_batched(
            state, xt, full_cov=full_cov, n_streams=self.n_streams, nt_valid=nt_valid,
            batch_dispatch=self.batch_dispatch,
        )

    # -- prediction ---------------------------------------------------------

    def _prep_shared(self, x_test) -> torch.Tensor:
        x_test = torch.as_tensor(x_test, device=self.device).to(self.dtype)
        d = self._xs[0].shape[-1]
        if x_test.ndim == 1:
            x_test = x_test[:, None]
        if x_test.ndim != 2 or x_test.shape[-1] != d:
            raise ValueError(
                f"GPFleet shared x_test must be (n̂, {d})" + (" or (n̂,)" if d == 1 else "")
                + f"; got {tuple(x_test.shape)}. Use predict_each for per-problem test sets."
            )
        return x_test

    def _predict_shared(self, x_test, full_cov: bool):
        """One shared (n̂, D) test block under every problem: one warm batched tail per bucket."""
        x_test = self._prep_shared(x_test)
        nh, b = x_test.shape[0], self.batch_size
        mean = torch.zeros((b, nh), dtype=self.dtype, device=self.device)
        sigma = torch.zeros((b, nh, nh), dtype=self.dtype, device=self.device) if full_cov else None
        for cap, idx in self.bucket_assignment().items():
            state = self._bucket_state(cap, idx)
            out = self._predict_bucket(state, x_test.expand((len(idx),) + x_test.shape), full_cov)
            rows = _index(idx, self.device)
            if full_cov:
                mean[rows], sigma[rows] = out
            else:
                mean[rows] = out
        return (mean, sigma) if full_cov else mean

    @_ieee_on_device
    def predict(self, x_test) -> torch.Tensor:
        """Means (B, n̂) for one shared (n̂, D) test block."""
        return self._predict_shared(x_test, full_cov=False)

    @_ieee_on_device
    def predict_full_cov(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._predict_shared(x_test, full_cov=True)

    @_ieee_on_device
    def predict_with_uncertainty(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, sigma = self.predict_full_cov(x_test)
        return mean, torch.diagonal(sigma, dim1=-2, dim2=-1)

    @_ieee_on_device
    def predict_each(self, x_test_list, *, full_cov: bool = False):
        """Per-problem test sets (a list of (n̂_i, D)).

        Ragged n̂_i are padded to each bucket's largest and masked with
        ``nt_valid``: one warm batched call a bucket, the results cut back
        to each problem's own n̂_i.  Returns a length-B list of (n̂_i,) means,
        or of ``(mean, cov)`` with cov (n̂_i, n̂_i) when ``full_cov``.  The
        calls only enqueue work on the card: nothing here reads a device
        value, so the caller's next host work overlaps the launches.
        """
        b = self.batch_size
        if len(x_test_list) != b:
            raise ValueError(f"predict_each needs one test set per problem ({b}); got {len(x_test_list)}")
        d = self._xs[0].shape[-1]
        tests = []
        for i, xt in enumerate(x_test_list):
            xt = torch.as_tensor(xt, device=self.device).to(self.dtype)
            if xt.ndim == 1:
                xt = xt[:, None]
            if xt.ndim != 2 or xt.shape[-1] != d:
                raise ValueError(f"test set {i} must be (n̂, {d}); got {tuple(xt.shape)}")
            tests.append(xt)
        out: List[object] = [None] * b
        empty = torch.zeros((0,), dtype=self.dtype, device=self.device)
        empty_cov = torch.zeros((0, 0), dtype=self.dtype, device=self.device)
        for cap, idx in self.bucket_assignment().items():
            nts = [tests[i].shape[0] for i in idx]
            if not any(nts):  # no query touches this bucket
                for i in idx:
                    out[i] = (empty, empty_cov) if full_cov else empty
                continue
            state = self._bucket_state(cap, idx)
            res = self._predict_bucket(
                state, _padded_block(tests, idx), full_cov, torch.tensor(nts, dtype=torch.int32)
            )
            for pos, i in enumerate(idx):
                k = nts[pos]
                out[i] = (res[0][pos, :k], res[1][pos, :k, :k]) if full_cov else res[pos, :k]
        return out

    # -- NLML ---------------------------------------------------------------

    @_ieee_on_device
    def nlml(self) -> torch.Tensor:
        """The (B,) NLMLs, one masked head per bucket (low-rank: the whitened form, as GPBatch)."""
        out = torch.zeros((self.batch_size,), dtype=self.dtype, device=self.device)
        for cap, idx in self.bucket_assignment().items():
            state = self._bucket_state(cap, idx)
            if self.method == "lowrank":
                vals = lowrank.whitened_nlml(state, dtype=self.dtype)
            else:
                _, ys, nv = self._stack(idx, cap)
                vals = mll.nlml_from_state(state, ys, dtype=self.dtype, n_valid=nv)
            out[_index(idx, self.device)] = vals.to(self.dtype)
        return out

    def log_marginal_likelihood(self) -> torch.Tensor:
        return -self.nlml()

    @_ieee_on_device
    def optimize(self, steps: int = 100, lr: float = 0.05) -> "GPFleet":
        """Fit every problem's hyperparameters at its own size (no padding rows in the loss).

        A loop of single-problem fits (:func:`mll.optimize_hyperparameters`
        on the problem's gathered leaves, through the tiled program or, on
        the low-rank tier, the Nystrom NLML with the fleet's inducing
        options); the results are stacked into (B,) + base leaves, so a leaf
        that started shared comes back per problem.  The caches are
        invalidated.
        """
        lr_tier = self.method == "lowrank"
        fitted = []
        for i in range(self.batch_size):
            pi = km.gather_params(self.params, i, self.kernel)
            ind = self.inducing
            if ind is not None and ind.ndim == 3:
                ind = ind[i]
            new_pi, _ = mll.optimize_hyperparameters(
                self._xs[i], self._ys[i], pi, steps=steps, lr=lr, dtype=self.dtype,
                method="lowrank" if lr_tier else "tiled", tile_size=self.tile_size, n_streams=self.n_streams,
                update_dtype=self.update_dtype, kernel=self.kernel, m_inducing=self.m_inducing,
                strategy=self.strategy, inducing=ind if lr_tier else None, jitter=self.jitter, device=self.device,
            )
            fitted.append(new_pi)
        self.params = km.tree_map(
            lambda *leaves: torch.stack([torch.as_tensor(l, device=self.device) for l in leaves]), *fitted
        )
        obs.inc("fleet.optimize")
        self.invalidate_cache()  # the factors belong to the old hyperparameters
        return self

    # -- ragged streaming updates -------------------------------------------

    @_ieee_on_device
    def update(self, x_new_list, y_new_list) -> "GPFleet":
        """Absorb ragged arrivals: problem i gains ``len(y_new_list[i])`` points (0 allowed).

        Problems that stay inside their bucket extend warm in O(n^2 b);
        problems that outgrow it migrate: the factor is re-embedded into the
        destination geometry as ``blockdiag(L, I)`` and extended there (the
        low-rank tier: a row gather of the mu-sized state, then one ragged
        absorb).  A cold or numerically failed bucket refactorizes on the
        next call.
        """
        b = self.batch_size
        if len(x_new_list) != b or len(y_new_list) != b:
            raise ValueError(
                f"update needs one arrival block per problem ({b}); got {len(x_new_list)} and {len(y_new_list)}"
            )
        d = self._xs[0].shape[-1]
        xn, yn = [], []
        for i, (x, y) in enumerate(zip(x_new_list, y_new_list)):
            x = torch.as_tensor(x, device=self.device).to(self.dtype).reshape(-1, d)
            y = torch.as_tensor(y, device=self.device).to(self.dtype).reshape(-1)
            if x.shape[0] != y.shape[0]:
                raise ValueError(f"arrival {i}: x has {x.shape[0]} rows, y {y.shape[0]}")
            xn.append(x)
            yn.append(y)
        counts = [y.shape[0] for y in yn]
        if not any(counts):
            return self
        old_key = self._cache_key()
        # each problem's warm source row: i -> (cap_old, state, row position)
        src: Dict[int, Tuple[int, object, int]] = {}
        for cap, idx in self.bucket_assignment().items():
            rec = self._buckets.get(cap)
            if rec is not None and rec.key == old_key and rec.idx == tuple(idx) and rec.state is not None:
                for pos, i in enumerate(idx):
                    src[i] = (cap, rec.state, pos)
        old_ns = self.sizes
        for i in range(b):
            if counts[i]:
                self._xs[i] = torch.cat([self._xs[i], xn[i]])
                self._ys[i] = torch.cat([self._ys[i], yn[i]])
        self._version += 1
        new_key = self._cache_key()
        new_buckets: Dict[int, _Bucket] = {}
        lr_tier = self.method == "lowrank"
        for cap, idx in self.bucket_assignment().items():
            state = None
            if all(i in src for i in idx):
                try:
                    cnt = [counts[i] for i in idx]
                    if lr_tier:
                        state = self._gather_lowrank_rows(cap, idx, src)
                    else:
                        state = self._transfer_bucket(cap, idx, src, old_ns)
                    if any(cnt):
                        xa, ya = _padded_block(xn, idx), _padded_block(yn, idx)
                        if lr_tier:
                            state = lowrank.absorb(
                                state, xa, ya, torch.tensor(cnt, dtype=torch.int32), sign=1,
                                n_streams=self.n_streams, update_dtype=self.update_dtype,
                                batch_dispatch=self.batch_dispatch,
                            )
                        else:
                            state = upd.extend_state_ragged(
                                state, xa, ya, cnt, n_streams=self.n_streams, update_dtype=self.update_dtype,
                                batch_dispatch=self.batch_dispatch,
                            )
                except upd.CholeskyUpdateError:
                    obs.health_event("refactorize_fallback", site="fleet.update.lowrank" if lr_tier else "fleet.update",
                                     cap=cap)
                    state = None
            new_buckets[cap] = _Bucket(tuple(idx), state, new_key)
        self._buckets = new_buckets
        return self

    def _transfer_bucket(self, cap, idx, src, old_ns) -> pred.PosteriorState:
        """A destination bucket's pre-append state from warm source rows.

        A factor that crosses a geometry boundary is re-embedded as
        blockdiag(L, I) (``tiling.embed_packed``, a gather); the chunk
        stacks are zero-padded to the new capacity.
        """
        fpad = torch.nn.functional.pad
        lp, al, xc, be, yc = [], [], [], [], []
        for i in idx:
            cap_s, st, pos = src[i]
            lpi = st.lpacked[pos]
            if cap_s != cap:
                lpi = tiling.embed_packed(lpi, cap_s, cap)
            pad = cap - cap_s
            lp.append(lpi)
            al.append(fpad(st.alpha[pos], (0, 0, 0, pad)))
            be.append(fpad(st.beta[pos], (0, 0, 0, pad)))
            yc.append(fpad(st.y_chunks[pos], (0, 0, 0, pad)))
            xc.append(fpad(st.x_chunks[pos], (0, 0, 0, 0, 0, pad)))
        nv = km._to_device(torch.tensor([old_ns[i] for i in idx], dtype=torch.int32), self.device)
        return pred.PosteriorState(
            lpacked=torch.stack(lp), alpha=torch.stack(al), x_chunks=torch.stack(xc),
            n=cap * self.tile_size, m=self.tile_size, params=self._bucket_params(idx),
            beta=torch.stack(be), y_chunks=torch.stack(yc), n_valid=nv, kernel=self.kernel,
        )

    def _gather_lowrank_rows(self, cap, idx, src) -> lowrank.LowRankState:
        """A destination bucket's pre-absorb low-rank state: a row gather of the warm sources.

        Every per-problem piece is mu-sized, so nothing is padded or
        re-embedded.  The port's ``c_w`` is gathered with the rest, and the
        (B,) frontiers are gathered on the device, never read on the host.
        """
        rows = [src[i][1:] for i in idx]

        def g(field):
            return torch.stack([getattr(st, field)[pos] for st, pos in rows])

        def frontier(field, default):
            """A (B,) frontier from each source's own: its (B,) row, its int, or ``default(state)``."""
            if all(getattr(st, field) is None for st, _ in rows):
                return None
            out = []
            for st, pos in rows:
                v = getattr(st, field)
                if isinstance(v, torch.Tensor):
                    out.append(v[pos].to(torch.int32))
                else:
                    out.append(torch.full((), default(st) if v is None else v, dtype=torch.int32, device=self.device))
            return torch.stack(out)

        return lowrank.LowRankState(
            u_chunks=g("u_chunks"), luu_packed=g("luu_packed"), b_packed=g("b_packed"),
            lb_packed=g("lb_packed"), c_chunks=g("c_chunks"), gamma=g("gamma"), c_w=g("c_w"),
            yty=g("yty"), n=cap * self.tile_size, m=self.tile_size, m_inducing=self.m_inducing,
            params=self._bucket_params(idx), jitter=rows[0][0].jitter,
            mu_valid=frontier("mu_valid", lambda st: st.m_inducing), n_valid=frontier("n_valid", lambda st: st.n),
            kernel=self.kernel,
        )
