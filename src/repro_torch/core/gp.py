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
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import kernels_math as km
from repro_torch.core import lowrank
from repro_torch.core import mll
from repro_torch.core import predict as pred
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
    host, once per cold build, never on the per-predict path.
    """
    jit = float(base_jitter)
    state = build(jit)
    for _ in range(2):
        if bool(torch.isfinite(state.luu_packed).all() & torch.isfinite(state.lb_packed).all()):
            return state
        jit = max(jit, lowrank.DEFAULT_JITTER) * 10.0
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
            self.invalidate_cache()

    # -- prediction ---------------------------------------------------------

    def _predict_tiled(self, x_test: torch.Tensor, full_cov: bool):
        """Cached factor -> the staged tail; cold + ``fused`` -> one
        whole-pipeline program whose buffers also fill the posterior cache;
        cold staged -> posterior() then the tail."""
        key = self._cache_key()
        if self._posterior is not None and self._posterior_key == key:
            state = self._posterior
        elif self.fused:
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
            state = self.posterior()
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
