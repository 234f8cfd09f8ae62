"""Core of the port: tiled, device-resident GP regression in PyTorch."""

from repro_torch.core.gp import GaussianProcess
from repro_torch.core.kernels_math import (
    ARDKernelParams,
    ARDSquaredExponential,
    Kernel,
    Matern12,
    Matern32,
    Matern52,
    Product,
    RationalQuadratic,
    RQKernelParams,
    Scaled,
    ScaledParams,
    SEKernelParams,
    SquaredExponential,
    Sum,
    White,
    WhiteKernelParams,
    get_kernel,
    register_kernel,
    resolve_kernel,
)
from repro_torch.core.lowrank import LowRankState
from repro_torch.core.mll import (
    negative_log_marginal_likelihood,
    nlml_lowrank,
    nlml_tiled,
    optimize_hyperparameters,
)
from repro_torch.core.predict import PosteriorState

__all__ = [
    "GaussianProcess",
    "LowRankState",
    "PosteriorState",
    "Kernel",
    "SquaredExponential",
    "Matern12",
    "Matern32",
    "Matern52",
    "RationalQuadratic",
    "ARDSquaredExponential",
    "White",
    "Sum",
    "Product",
    "Scaled",
    "SEKernelParams",
    "RQKernelParams",
    "ARDKernelParams",
    "WhiteKernelParams",
    "ScaledParams",
    "get_kernel",
    "register_kernel",
    "resolve_kernel",
    "negative_log_marginal_likelihood",
    "nlml_tiled",
    "nlml_lowrank",
    "optimize_hyperparameters",
]
