"""Covariance-tile assembly: the CUDA kernel and its plain version.

Replaces ``repro/kernels/cov_assembly.py::_cov_tile_kernel``.  One launch
assembles a whole stack of tiles — the packed lower triangle (ASSEMBLE), a
cross-covariance grid (CROSS) or the prior test grid (PRIOR) — for any
family of the registry and any composite, and for one problem or a fleet of
B problems at once.  The source, with what bounds it on the H100 and what
the design does about it, is ``csrc/cov_assembly.cu``.

The kernel tree reaches the kernel as a descriptor
(:func:`repro_torch.core.kernels_math.descriptor_table`): its structure, a
sum of at most ``MAX_TERMS`` products of at most ``MAX_FACTORS`` scaled
leaves, as a grid constant, and its reals as a device table of one row per
problem (P = 1 for shared hyperparameters, B for (B,) leaves), so one build
serves every family, composite, parameter value and fleet, and the
hyperparameters never travel through the host.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core import kernels_math as km
from repro_torch.kernels import _build

# the descriptor's limits, leaf ids and table row, as csrc/cov_assembly.cu defines them
MAX_TERMS, MAX_FACTORS, MAX_ARD_D = km.DESC_MAX_TERMS, km.DESC_MAX_FACTORS, km.DESC_MAX_ARD_D
LEAF_IDS = km.DESC_LEAF_IDS
COMPOSITE = km.DESC_COMPOSITE
TABLE_WIDTH = km.DESC_WIDTH


def cov_tiles_plain(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None
) -> torch.Tensor:
    """(T, m, D) x (T, mb, D) -> (T, m, mb) masked covariance tiles, in torch ops.

    Per-problem params (leaves (P,) + base) take T = P * G tiles, problem-major.
    """
    return km.cov_tile(xa, xb, row0, col0, params, n_valid_r, n_valid_c, symmetric, kernel)


def _i32(v, t: int, device) -> torch.Tensor:
    """A scalar or (T,) integer operand as a contiguous (T,) int32 tensor on ``device``.

    A Python integer is filled in on the device: copying it from the host would
    synchronise the stream (a pageable copy) on every launch.
    """
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(t).contiguous()
    return torch.full((t,), int(v), dtype=torch.int32, device=device)


def _launch(xa, xb, row0, col0, nvr, nvc, launch: km.DescriptorLaunch, symmetric: bool) -> torch.Tensor:
    t, m, d = xa.shape
    mb = xb.shape[1]
    dev = xa.device
    table = launch.table
    if table.dtype != xa.dtype or table.device != dev or table.shape[1] != TABLE_WIDTH or t % table.shape[0]:
        raise ValueError(
            f"cov_tiles: a descriptor table {tuple(table.shape)} {table.dtype} on {table.device} "
            f"does not fit {t} tiles of {xa.dtype} on {dev}"
        )
    out = torch.empty((t, m, mb), dtype=xa.dtype, device=dev)
    lib = _build.load("cov_assembly")
    fn = lib.cov_tiles_f32 if xa.dtype == torch.float32 else lib.cov_tiles_f64
    ints = launch.ints
    code = fn(
        xa.data_ptr(), xb.data_ptr(), row0.data_ptr(), col0.data_ptr(),
        nvr.data_ptr(), nvc.data_ptr(), out.data_ptr(), t, m, mb, d,
        (ctypes.c_int * len(ints))(*ints), table.data_ptr(), table.shape[0],
        int(launch.ard), int(symmetric), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "cov_tiles")
    cov_tiles_cuda.launches += 1
    return out


def cov_tiles_cuda(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None,
    table: Optional[km.Descriptor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on a stack of tiles, for any family, composite or fleet.

    ``table`` is the kernel tree's descriptor for these tiles' dtype and
    device (:func:`repro_torch.core.kernels_math.descriptor_table`), built
    once by a program run for all its launches; without it the call builds
    its own from ``params``.  Per-problem params (P problems) take T = P * G
    tiles, problem-major.  Terms that mix distances (an ARD leaf beside
    isotropic ones) run one launch per distance, and their tiles are
    combined here.  ``cov_tiles_cuda.launches`` counts the kernel's launches
    (one per distance), read by :func:`repro_torch.kernels.ops.launch_counts`.
    """
    kernel = km.resolve_kernel(kernel)
    if xa.dtype not in (torch.float32, torch.float64) or xb.dtype != xa.dtype:
        raise TypeError(f"cov_tiles takes float32 or float64 features, got {xa.dtype}/{xb.dtype}")
    if xa.device != xb.device or xa.device.type != "cuda":
        raise ValueError(f"cov_tiles needs both stacks on one CUDA device: {xa.device}, {xb.device}")
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[0] != xb.shape[0] or xa.shape[2] != xb.shape[2]:
        raise ValueError(f"cov_tiles takes (T, m, D) and (T, mb, D), got {tuple(xa.shape)}, {tuple(xb.shape)}")
    if not (xa.is_contiguous() and xb.is_contiguous()):
        raise ValueError("cov_tiles takes contiguous feature stacks")
    t = xa.shape[0]
    dev = xa.device
    if table is None:
        table = km.descriptor_table(kernel, params, xa.shape[2], xa.dtype, dev)
    row0, col0 = _i32(row0, t, dev), _i32(col0, t, dev)
    nvr, nvc = _i32(n_valid_r, t, dev), _i32(n_valid_c, t, dev)
    if not table.mixed:
        return _launch(xa, xb, row0, col0, nvr, nvc, table.launches[0], symmetric)
    # one launch per (term, distance), as cross tiles; the pin and the identity padding last
    out, prod, term = None, None, None
    for launch, t_of in zip(table.launches, table.terms):
        tile = _launch(xa, xb, row0, col0, nvr, nvc, launch, False)
        if t_of != term:
            out = prod if out is None else out.add_(prod)
            prod, term = tile, t_of
        else:
            prod.mul_(tile)
    out = prod if out is None else out.add_(prod)
    if not symmetric:
        return out
    p = table.problems
    diag = table.diag.reshape(p, 1, 1, 1).expand(p, t // p, 1, 1).reshape(t, 1, 1)
    return km.mask_tiles(out, row0, col0, nvr, nvc, True, diag)


def cov_tiles_tolerance(kernel, params, xa: torch.Tensor, xb: torch.Tensor) -> float:
    """The largest |kernel - plain version| the kernel's accuracy contract allows on these inputs.

    Both sides form the distance from rounded features: the expanded form's
    d2 carries an error up to ~8 eps N, N = max|a|^2 + max|b|^2 (for ARD in
    units of l, where the plain version's expanded form meets the kernel's
    difference form).  A leaf moves by at most |dk/dd2| times that: 1/(2l)
    for SE, RQ and ARD, 3/(2l) for Matérn 3/2, 5/(6l) for 5/2; Matérn 1/2
    has no bound on dk/dd2 at d2 = 0 (dk/dr = -1), so it moves by
    sqrt(8 eps N / l).  The rest is the float32 MUFU exp, sqrt and log
    (relative ~2^-22), allowed 1e-5 of the kernel's largest value (1e-12 in
    float64).  Each term adds |coef| times the sum over its factors.
    """
    eps = torch.finfo(xa.dtype).eps
    base = 1e-5 if xa.dtype == torch.float32 else 1e-12
    terms = km.normal_form(kernel, params)
    scale = max(1.0, sum(abs(c) for c, _ in terms))
    tol = base * scale
    for c, fs in terms:
        for f in fs:
            if f.family == "ard":
                ls = torch.as_tensor(f.lengthscale, dtype=torch.float64).to(xa.device)
                big = float((xa.double() ** 2 / ls).sum(-1).max() + (xb.double() ** 2 / ls).sum(-1).max())
                dd2, slope = 8 * eps * big, 0.5
            else:
                big = float((xa.double() ** 2).sum(-1).max() + (xb.double() ** 2).sum(-1).max())
                dd2, l = 8 * eps * big, float(f.lengthscale)
                slope = {"se": 0.5 / l, "rq": 0.5 / l, "matern32": 1.5 / l, "matern52": 5.0 / (6.0 * l)}.get(f.family)
            move = math.sqrt(dd2 / float(f.lengthscale)) if f.family == "matern12" else slope * dd2
            tol += abs(c) * move
    return tol

