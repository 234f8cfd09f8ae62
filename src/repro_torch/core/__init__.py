"""Core of the port: tiled, device-resident GP regression in PyTorch."""

from repro_torch.core.gp import GaussianProcess
from repro_torch.core.kernels_math import (
    Kernel,
    SEKernelParams,
    SquaredExponential,
    get_kernel,
    register_kernel,
    resolve_kernel,
)
from repro_torch.core.lowrank import LowRankState
from repro_torch.core.predict import PosteriorState

__all__ = [
    "GaussianProcess",
    "LowRankState",
    "PosteriorState",
    "Kernel",
    "SquaredExponential",
    "SEKernelParams",
    "get_kernel",
    "register_kernel",
    "resolve_kernel",
]
