"""Covariance-tile assembly: the CUDA kernel and its plain version.

Replaces ``repro/kernels/cov_assembly.py::_cov_tile_kernel``.  One launch
assembles a whole stack of tiles — the packed lower triangle (ASSEMBLE), a
cross-covariance grid (CROSS) or the prior test grid (PRIOR) — for any
family of the registry and any composite.  The source, with what bounds it
on the H100 and what the design does about it, is ``csrc/cov_assembly.cu``.
The kernel tree reaches the kernel as a small descriptor of runtime scalars
(:func:`descriptor`: a sum of at most ``MAX_TERMS`` products of at most
``MAX_FACTORS`` scaled leaves), so one build serves every family, every
composite and every parameter value.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from repro_torch.core import kernels_math as km
from repro_torch.kernels import _build

# the descriptor's limits and leaf ids, as csrc/cov_assembly.cu defines them
MAX_TERMS, MAX_FACTORS, MAX_ARD_D = 4, 3, 64
LEAF_IDS = {"se": 0, "matern12": 1, "matern32": 2, "matern52": 3, "rq": 4}
COMPOSITE = 5


def cov_tiles_plain(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None
) -> torch.Tensor:
    """(T, m, D) x (T, mb, D) -> (T, m, mb) masked covariance tiles, in torch ops."""
    return km.cov_tile(xa, xb, row0, col0, params, n_valid_r, n_valid_c, symmetric, kernel)


def _i32(v, t: int, device) -> torch.Tensor:
    """A scalar or (T,) integer operand as a contiguous (T,) int32 tensor on ``device``.

    A Python integer is filled in on the device: copying it from the host would
    synchronise the stream (a pageable copy) on every launch.
    """
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(t).contiguous()
    return torch.full((t,), int(v), dtype=torch.int32, device=device)


Terms = List[Tuple[float, Tuple[km.Factor, ...]]]


def _distance(f: km.Factor):
    """The distance a factor reads: None (the isotropic expanded form) or its ARD lengthscales."""
    return f.lengthscale if f.family == "ard" else None


def descriptor(terms: Terms, d: int):
    """(ints, reals, ard) of the kernel's descriptor for terms that all read one distance.

    ``ard`` is None or the ARD lengthscales (one shared value is broadcast
    over the ``d`` features).  Raises ValueError past the descriptor's limits.
    """
    if len(terms) > MAX_TERMS or any(len(fs) > MAX_FACTORS for _, fs in terms):
        raise ValueError(
            f"the cov_tiles kernel takes at most {MAX_TERMS} terms of {MAX_FACTORS} factors; the "
            f"kernel's normal form has {[len(fs) for _, fs in terms]}"
        )
    ards = {_distance(f) for _, fs in terms for f in fs}
    if len(ards) > 1:
        raise ValueError("one launch reads one distance")
    ard = next(iter(ards)) if ards else None
    nf = MAX_TERMS * MAX_FACTORS
    n_factors, fam, coef = [0] * MAX_TERMS, [0] * nf, [0.0] * MAX_TERMS
    ls, alpha = [1.0] * nf, [1.0] * nf
    for t, (c, fs) in enumerate(terms):
        coef[t], n_factors[t] = float(c), len(fs)
        for q, f in enumerate(fs):
            i = t * MAX_FACTORS + q
            if f.family == "ard":  # SE with l = 1 on the ARD distance
                fam[i] = LEAF_IDS["se"]
            else:
                fam[i], ls[i] = LEAF_IDS[f.family], float(f.lengthscale)
                alpha[i] = float(f.alpha) if f.family == "rq" else 1.0
    single = len(terms) == 1 and len(terms[0][1]) == 1
    kind = fam[0] if single else COMPOSITE
    ard_l = [1.0] * MAX_ARD_D
    if ard is not None:
        if d > MAX_ARD_D:
            raise ValueError(f"the cov_tiles kernel's ARD distance takes at most {MAX_ARD_D} features, got {d}")
        full = ard * d if len(ard) == 1 else ard
        if len(full) != d:
            raise ValueError(f"{len(full)} ARD lengthscales for {d} features")
        ard_l[:d] = [float(v) for v in full]
    ints = [kind, len(terms), *n_factors, *fam]
    reals = [*coef, *ls, *alpha, *ard_l]
    return ints, reals, ard


def _launch(xa, xb, row0, col0, nvr, nvc, terms: Terms, diagval: float, symmetric: bool) -> torch.Tensor:
    t, m, d = xa.shape
    mb = xb.shape[1]
    dev = xa.device
    ints, reals, ard = descriptor(terms, d)
    out = torch.empty((t, m, mb), dtype=xa.dtype, device=dev)
    lib = _build.load("cov_assembly")
    fn = lib.cov_tiles_f32 if xa.dtype == torch.float32 else lib.cov_tiles_f64
    code = fn(
        xa.data_ptr(), xb.data_ptr(), row0.data_ptr(), col0.data_ptr(),
        nvr.data_ptr(), nvc.data_ptr(), out.data_ptr(), t, m, mb, d,
        (ctypes.c_int * len(ints))(*ints), (ctypes.c_double * len(reals))(*reals),
        int(ard is not None), diagval, int(symmetric),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "cov_tiles")
    cov_tiles_cuda.launches += 1
    return out


def cov_tiles_cuda(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None
) -> torch.Tensor:
    """Launch the CUDA kernel on a stack of tiles, for any family or composite.

    Hyperparameters are read to the host (:func:`km.normal_form`); the
    global diagonal's ``diag + noise`` is summed in double there and rounded
    once.  Terms that mix distances (an ARD leaf beside isotropic ones) run
    one launch per distance, and their tiles are combined here.
    ``cov_tiles_cuda.launches`` counts the kernel's launches (one per
    distance), read by :func:`repro_torch.kernels.ops.launch_counts`.
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
    row0, col0 = _i32(row0, t, dev), _i32(col0, t, dev)
    nvr, nvc = _i32(n_valid_r, t, dev), _i32(n_valid_c, t, dev)
    p = km.concrete_params(params)
    diagval = float(kernel.diag(p)) + float(kernel.noise(p))
    terms = km.normal_form(kernel, params)
    if len({_distance(f) for _, fs in terms for f in fs}) <= 1:
        return _launch(xa, xb, row0, col0, nvr, nvc, terms, diagval, symmetric)
    # one launch per (term, distance), as cross tiles; the pin and the identity padding last
    out = None
    for c, fs in terms:
        prod = None
        for dist in dict.fromkeys(_distance(f) for f in fs):
            part = [f for f in fs if _distance(f) == dist]
            tile = _launch(xa, xb, row0, col0, nvr, nvc, [(c if prod is None else 1.0, tuple(part))],
                           0.0, False)
            prod = tile if prod is None else prod.mul_(tile)
        out = prod if out is None else out.add_(prod)
    if not symmetric:
        return out
    return km.mask_tiles(out, row0, col0, nvr, nvc, True, torch.full((), diagval, dtype=out.dtype, device=dev))


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

