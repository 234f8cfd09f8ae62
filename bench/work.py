"""The work a request needs, counted from its shapes: the benchmark's yardstick.

Each function returns the floating-point operations and the bytes of one
request (for training, one Adam step) of the algorithm, not of what the
program launches, so a count stays the same whatever implements it.  Bytes
count each input read once and each output written once; a request that
starts from a cached posterior reads that posterior as its input.

A covariance entry costs 2 D + 4 operations: the dot product of the
expanded squared distance (2 D), adding the two norms and scaling (3), and
the exponential (1).  A Cholesky factor of order n costs n^3 / 3, a
triangular solve with r right-hand sides n^2 r, a product of an (a, k) and
a (k, b) matrix 2 a k b, and a symmetric one a^2 k.

The peaks are NVIDIA's published dense rates for one H100 SXM at 700 W:
67 TFLOP/s in float32 outside the tensor cores (the port computes float32
with TF32 off) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "H100": {"flops_per_s": 67e12, "bytes_per_s": 3.35e12},
}
F32 = 4


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``device_name``, or None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def entry(d: int) -> int:
    return 2 * d + 4


def cold_exact(n: int, nt: int, d: int) -> Dict[str, float]:
    """Mean of an exact GP at nt points: ASSEMBLE (lower triangle), the factor, the two alpha solves, CROSS and the mean."""
    flops = n * (n + 1) / 2 * entry(d) + n**3 / 3 + 2 * n**2 + nt * n * entry(d) + 2 * nt * n
    return {"flops": flops, "bytes": F32 * (n * d + n + nt * d + nt)}


def cold_lowrank(n: int, nt: int, d: int, m: int) -> Dict[str, float]:
    """DTC mean at nt points over m inducing points: K_uu, K_un, the symmetric K_un K_nu, c = K_un y,
    the factor of A = K_uu + s^-2 K_un K_nu, its two solves, CROSS and the mean."""
    flops = (m * (m + 1) / 2 + n * m + nt * m) * entry(d) + n * m**2 + 2 * n * m + m**3 / 3 + 2 * m**2 + 2 * nt * m
    return {"flops": flops, "bytes": F32 * (n * d + n + nt * d + nt)}


def warm_uncertainty(n: int, b: int, d: int) -> Dict[str, float]:
    """Mean and variance at b points from a cached factor: CROSS, the mean, L^-1 K_* and the variance's diagonal."""
    flops = b * n * entry(d) + 2 * b * n + n**2 * b + 2 * n * b + b
    factor = n * (n + 1) / 2
    return {"flops": flops, "bytes": F32 * (factor + n + n * d + b * d + 2 * b)}


def train_step(n: int, d: int) -> Dict[str, float]:
    """One Adam step on the exact NLML: ASSEMBLE, the factor, alpha, K^-1 from the factor (2 n^3 / 3) and
    the contraction of S = (K^-1 - alpha alpha^T) / 2 with dK/dl and dK/dv (8 operations an entry of a triangle)."""
    flops = n * (n + 1) / 2 * entry(d) + n**3 / 3 + 2 * n**2 + 2 * n**3 / 3 + n * (n + 1) / 2 * 8
    return {"flops": flops, "bytes": F32 * (n * d + n + 3 + 3)}


def least_seconds(work: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The larger of operations over the peak rate and bytes over the bandwidth."""
    return max(work["flops"] / peaks["flops_per_s"], work["bytes"] / peaks["bytes_per_s"])
