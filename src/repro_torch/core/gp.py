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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import kernels_math as km
from repro_torch.core import predict as pred
from repro_torch.device import resolve_device


def _params_key(params):
    """Hashable digest of a hyperparameter dataclass (host bytes of each field)."""
    return tuple(
        torch.as_tensor(getattr(params, f.name)).detach().cpu().numpy().tobytes()
        for f in dataclasses.fields(params)
    )


def disable_tf32() -> None:
    """Keep float32 products in IEEE float32 on the card (no TF32).

    GRAM, the cross-covariance matvecs and the solves go through cuBLAS and
    cuSOLVER; TF32 there would loosen the float32 parity with the JAX
    reference without any sign of it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    # covariance family: None / registry name / Kernel instance
    kernel: Optional[object] = None
    # approximation tier; only "exact" is ported so far
    method: str = "exact"
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.kernel = km.resolve_kernel(self.kernel)
        if self.params is None:
            self.params = self.kernel.default_params()
        if self.method != "exact":
            raise ValueError(
                f"method must be 'exact' (the only tier ported so far), got {self.method!r}"
            )
        if self.pipeline not in ("tiled", "monolithic"):
            raise ValueError(
                f"pipeline must be 'tiled' or 'monolithic', got {self.pipeline!r}"
            )
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
        self._posterior: Optional[pred.PosteriorState] = None
        self._posterior_key = None

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
        )

    def _cache_warm(self) -> bool:
        return self._posterior is not None and self._posterior_key == self._cache_key()

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

    def invalidate_cache(self) -> None:
        self._posterior = None
        self._posterior_key = None

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

    def predict(self, x_test) -> torch.Tensor:
        x_test = self._prep(x_test)
        if self.pipeline == "monolithic":
            return self._predict_monolithic(x_test, full_cov=False)
        return self._predict_tiled(x_test, full_cov=False)

    def predict_full_cov(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        """The paper's *Predict with Full Covariance Matrix* operation."""
        x_test = self._prep(x_test)
        if self.pipeline == "monolithic":
            return self._predict_monolithic(x_test, full_cov=True)
        return self._predict_tiled(x_test, full_cov=True)

    def predict_with_uncertainty(self, x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, sigma = self.predict_full_cov(x_test)
        return mean, torch.diagonal(sigma)

    def _prep(self, x_test) -> torch.Tensor:
        x_test = torch.as_tensor(x_test, device=self.device).to(self.dtype)
        if x_test.ndim == 1:
            x_test = x_test[:, None]
        return x_test
