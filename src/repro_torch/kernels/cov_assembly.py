"""Covariance-tile assembly: the CUDA kernel and its plain version.

Replaces ``repro/kernels/cov_assembly.py::_cov_tile_kernel``.  One launch
assembles a whole stack of tiles — the packed lower triangle (ASSEMBLE), a
cross-covariance grid (CROSS) or the prior test grid (PRIOR).  The source,
with what bounds it on the H100 and what the design does about it, is
``csrc/cov_assembly.cu``.  Hyperparameters reach the kernel as runtime
scalars, so one build serves every parameter value.
"""

from __future__ import annotations

import torch

from repro_torch.core import kernels_math as km
from repro_torch.kernels import _build


def cov_tiles_plain(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None
) -> torch.Tensor:
    """(T, m, D) x (T, mb, D) -> (T, m, mb) masked covariance tiles, in torch ops."""
    return km.cov_tile(xa, xb, row0, col0, params, n_valid_r, n_valid_c, symmetric, kernel)


def _i32(v, t: int, device) -> torch.Tensor:
    """A scalar or (T,) integer operand as a contiguous (T,) int32 tensor."""
    return torch.as_tensor(v, dtype=torch.int32, device=device).expand(t).contiguous()


def cov_tiles_cuda(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None
) -> torch.Tensor:
    """Launch the CUDA kernel on a stack of tiles (squared-exponential only)."""
    kernel = km.resolve_kernel(kernel)
    if not isinstance(kernel, km.SquaredExponential):
        raise NotImplementedError(
            f"the cov_assembly CUDA kernel implements the SE kernel, not {kernel.name!r}"
        )
    if xa.dtype not in (torch.float32, torch.float64) or xb.dtype != xa.dtype:
        raise TypeError(f"cov_tiles takes float32 or float64 features, got {xa.dtype}/{xb.dtype}")
    if xa.device != xb.device or xa.device.type != "cuda":
        raise ValueError(f"cov_tiles needs both stacks on one CUDA device: {xa.device}, {xb.device}")
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[0] != xb.shape[0] or xa.shape[2] != xb.shape[2]:
        raise ValueError(f"cov_tiles takes (T, m, D) and (T, mb, D), got {tuple(xa.shape)}, {tuple(xb.shape)}")
    if not (xa.is_contiguous() and xb.is_contiguous()):
        raise ValueError("cov_tiles takes contiguous feature stacks")
    t, m, d = xa.shape
    mb = xb.shape[1]
    dev = xa.device
    row0, col0 = _i32(row0, t, dev), _i32(col0, t, dev)
    nvr, nvc = _i32(n_valid_r, t, dev), _i32(n_valid_c, t, dev)
    p = params.as_floats()
    diagval = float(kernel.diag(p)) + float(kernel.noise(p))
    out = torch.empty((t, m, mb), dtype=xa.dtype, device=dev)
    lib = _build.load("cov_assembly")
    fn = lib.cov_tiles_f32 if xa.dtype == torch.float32 else lib.cov_tiles_f64
    code = fn(
        xa.data_ptr(), xb.data_ptr(), row0.data_ptr(), col0.data_ptr(),
        nvr.data_ptr(), nvc.data_ptr(), out.data_ptr(), t, m, mb, d,
        -0.5 / p.lengthscale, p.vertical, diagval, int(symmetric),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "cov_tiles")
    return out
