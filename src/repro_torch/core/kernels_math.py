"""Gaussian-process covariance math: the kernel contract, SE, and plain assembly.

The paper (Eq. 1) uses the squared-exponential kernel

    k(x_i, x_j) = v * exp( -1/(2*l) * sum_d (x_i_d - x_j_d)^2 ) + delta_ij * sigma^2

with lengthscale ``l``, vertical lengthscale ``v`` and noise variance
``sigma^2``.  The paper divides by ``2*l`` (not ``2*l**2``); the port keeps
that convention exactly, as the JAX package does.

A kernel is a frozen dataclass implementing:

  * ``kfree(params, xa, xb)`` — the noise-free covariance block (torch ops,
    leading batch axes allowed);
  * ``noise(params)`` — the variance added on the global training diagonal;
  * ``diag(params)`` — the exact ``kfree(x, x)``; assembly pins the global
    diagonal to ``diag + noise`` instead of trusting the cancellation-prone
    expanded distance form;
  * ``default_params()``.

Hyperparameters are a small dataclass of floats or 0-d tensors.  The
registry holds ``"se"``; the other families of the JAX package's zoo come
with a later slice.  Padding contract: rows/cols with global index
``>= n_valid`` become identity (training covariance) or zero (cross/prior
covariance), so the padded system solves the unpadded one exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SEKernelParams:
    """Hyperparameters of the paper's SE kernel (Eq. 1): floats or 0-d tensors."""

    lengthscale: Scalar = 1.0
    vertical: Scalar = 1.0
    noise: Scalar = 0.1  # sigma^2 (variance, not std)

    @staticmethod
    def paper_defaults() -> "SEKernelParams":
        # Section 4.1: l = 1, v = 1, sigma^2 = 0.1.
        return SEKernelParams(1.0, 1.0, 0.1)

    def as_floats(self) -> "SEKernelParams":
        """The same parameters as Python floats (reads a 0-d tensor to the host)."""
        return SEKernelParams(
            float(self.lengthscale), float(self.vertical), float(self.noise)
        )


def sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances, (..., n1, D) x (..., n2, D) -> (..., n1, n2).

    The expanded form |a|^2 + |b|^2 - 2 a.b, clamped at zero, as the JAX
    reference computes it.  It cancels catastrophically for large-magnitude
    inputs, which is why training assembly pins the global diagonal.
    """
    n1sq = torch.sum(x1 * x1, dim=-1, keepdim=True)          # (..., n1, 1)
    n2sq = torch.sum(x2 * x2, dim=-1).unsqueeze(-2)          # (..., 1, n2)
    cross = x1 @ x2.transpose(-1, -2)
    return torch.clamp(n1sq + n2sq - 2.0 * cross, min=0.0)


class Kernel:
    """Base of the kernel contract (see the module docstring)."""

    name: ClassVar[str] = "kernel"

    def default_params(self):
        raise NotImplementedError

    def kfree(self, params, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def noise(self, params):
        return params.noise

    def diag(self, params):
        return params.vertical


@dataclasses.dataclass(frozen=True)
class SquaredExponential(Kernel):
    """The paper's kernel: k = v * exp(-d2 / (2 l)); ``l`` enters unsquared."""

    name: ClassVar[str] = "se"

    def default_params(self) -> SEKernelParams:
        return SEKernelParams.paper_defaults()

    def kfree(self, params, xa, xb):
        return params.vertical * torch.exp(-0.5 / params.lengthscale * sq_dists(xa, xb))


SQUARED_EXPONENTIAL = SquaredExponential()  # the default kernel everywhere

KERNEL_REGISTRY: dict[str, Callable[..., Kernel]] = {"se": SquaredExponential}


def register_kernel(name: str, factory: Callable[..., Kernel]) -> None:
    """Register a kernel factory under ``name`` (``get_kernel`` resolves it)."""
    KERNEL_REGISTRY[name] = factory


def get_kernel(name: str, **kwargs) -> Kernel:
    try:
        factory = KERNEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(KERNEL_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def resolve_kernel(kernel) -> Kernel:
    """None -> the SE default; a registry name -> its instance; else as-is."""
    if kernel is None:
        return SQUARED_EXPONENTIAL
    if isinstance(kernel, str):
        return get_kernel(kernel)
    return kernel


def _diag_value(kernel: Kernel, params, dtype, device) -> torch.Tensor:
    """``diag + noise`` rounded once to ``dtype`` (summed in double for floats)."""
    val = kernel.diag(params) + kernel.noise(params)
    if isinstance(val, torch.Tensor):
        return val.to(dtype=dtype, device=device)
    return torch.tensor(val, dtype=dtype, device=device)


def cov_tile(
    xa: torch.Tensor,
    xb: torch.Tensor,
    row0,
    col0,
    params,
    n_valid_r,
    n_valid_c,
    symmetric: bool,
    kernel: Optional[Kernel] = None,
) -> torch.Tensor:
    """Covariance tiles with global-index masking, batched over leading axes.

    xa (..., m, D) rows, xb (..., mb, D) cols; ``row0``/``col0`` are global
    offsets (ints or tensors of the batch shape); ``n_valid_r``/``n_valid_c``
    ints or tensors of the batch shape.  Symmetric tiles pin the global
    diagonal to the exact ``diag + noise`` and are identity in the padded
    region; cross tiles are zero there.  This is the plain version of the
    ``cov_assembly`` CUDA kernel.
    """
    kernel = resolve_kernel(kernel)
    k = kernel.kfree(params, xa, xb)
    dev = k.device

    def col(v):  # (...,) -> (..., 1, 1) so it broadcasts over the tile
        v = torch.as_tensor(v, device=dev)
        return v.reshape(v.shape + (1, 1))

    gi = col(row0) + torch.arange(xa.shape[-2], device=dev)[:, None]
    gj = col(col0) + torch.arange(xb.shape[-2], device=dev)[None, :]
    on_diag = gi == gj
    valid = (gi < col(n_valid_r)) & (gj < col(n_valid_c))
    if symmetric:
        k = torch.where(on_diag, _diag_value(kernel, params, k.dtype, dev), k)
        return torch.where(valid, k, on_diag.to(k.dtype))
    return torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=dev))


# ---------------------------------------------------------------------------
# Dense assembly (the monolithic baseline's inputs).
# ---------------------------------------------------------------------------


def assemble_covariance(x: torch.Tensor, params, *, kernel=None) -> torch.Tensor:
    """Full training covariance K = K_XX + sigma^2 I, diagonal pinned exactly."""
    kernel = resolve_kernel(kernel)
    k = kernel.kfree(params, x, x)
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    return torch.where(eye, _diag_value(kernel, params, k.dtype, k.device), k)


def assemble_cross_covariance(
    x_test: torch.Tensor, x_train: torch.Tensor, params, *, kernel=None
) -> torch.Tensor:
    """Cross covariance K_{X̂,X} (n̂ × n)."""
    return resolve_kernel(kernel).kfree(params, x_test, x_train)


def assemble_prior_covariance(x_test: torch.Tensor, params, *, kernel=None) -> torch.Tensor:
    """Prior test covariance K_{X̂,X̂}, without observation noise."""
    return resolve_kernel(kernel).kfree(params, x_test, x_test)
