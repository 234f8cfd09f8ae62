"""Batch-invariant tile matvecs and diagonal-tile solves of a fleet: the CUDA kernels and their plain versions.

A port-only kernel: the JAX package leaves these steps to XLA (the
executor's GEMV, GEMV_B, XGEMV and TRSV steps, ``repro/core/executor.py``).
On the card cuBLAS's batched GEMV and triangular solve pick their algorithm
by the batch count, so that a problem of a fleet rounded differently with
another number of problems beside it, and a sharded fleet differed from the
unsharded one; taking them one problem at a time cost ~10% of fleet_batch's
cold call (``scripts/batch_invariance.py``).  Every choice that sets a
problem's arithmetic is fixed by the tile's shape and strides alone.

* ``tile_gemv(a, x)``: a (Z, G, Q, m, n), x (Z, G, Q, n), any strides (0
  broadcasts) -> (Z, G, m), ``out[z, g] = sum_q a[z, g, q] @ x[z, g, q]``.
* ``tile_trsv(l, r, transpose)``: l (Z, G, m, m) lower tiles with contiguous
  rows, r (Z, G, m) -> (Z, G, m), ``l^-1 r`` (or ``l^-T r``).

The GEMV is a bandwidth kernel: a warp a row of a row-major tile, a CTA a
slab of rows of a column-major (transposed) one, 16-byte loads where the
pointers allow, which give the same bits as the scalar loads.  The solve is
a latency kernel: a thread-block cluster a system, L's blocks resident in
(or streamed through) the CTAs' shared memory, x passed between them through
distributed shared memory.  :func:`gemv_variant` and :func:`trsv_plan` say
which variant a launch takes.  The plain versions take one einsum and one
batched ``solve_triangular`` a problem.  The source, with its design, is
``csrc/tile_gemv_trsv.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def tile_gemv_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One einsum a problem (batch-invariant: one call over the Z problems is not, on the CPU either)."""
    return torch.stack([torch.einsum("gqab,gqb->ga", ai, xi) for ai, xi in zip(a, x)])


def tile_trsv_plain(l: torch.Tensor, r: torch.Tensor, transpose: bool) -> torch.Tensor:
    """One batched ``solve_triangular`` a problem."""
    if transpose:
        return torch.stack([torch.linalg.solve_triangular(li.mT, ri[..., None], upper=True)[..., 0]
                            for li, ri in zip(l, r)])
    return torch.stack([torch.linalg.solve_triangular(li, ri[..., None], upper=False)[..., 0] for li, ri in zip(l, r)])


def _strides(*values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def _check(what, *ts) -> None:
    dt = ts[0].dtype
    if dt not in (torch.float32, torch.float64) or any(t.dtype != dt for t in ts):
        raise TypeError(f"{what} takes float32 or float64 operands of one type, got {[t.dtype for t in ts]}")
    if any(t.device != ts[0].device for t in ts) or ts[0].device.type != "cuda":
        raise ValueError(f"{what} needs every operand on one CUDA device: {[str(t.device) for t in ts]}")


GEMV_VARIANTS = ("rows/scalar", "rows/vector", "cols/scalar", "cols/vector")


def gemv_variant(a: torch.Tensor, x: torch.Tensor) -> str:
    """The route and load width that :func:`tile_gemv_cuda` takes for these operands (on the card)."""
    lib = _build.load("tile_gemv_trsv")
    return GEMV_VARIANTS[lib.tile_gemv_variant(a.data_ptr(), x.data_ptr(), a.shape[3], a.shape[4],
                                               _strides(*a.stride()), _strides(*x.stride()),
                                               int(a.dtype == torch.float64))]


@functools.lru_cache(maxsize=None)
def trsv_plan(m: int, dtype: torch.dtype) -> dict:
    """The solve's plan at (m, dtype), from the library (on the card): cluster size, variant, shared memory.

    Raises where no variant takes m."""
    lib = _build.load("tile_gemv_trsv")
    dbl = int(dtype == torch.float64)
    cluster, resident, smem = (lib.tile_trsv_plan(m, dbl, what) for what in range(3))
    if cluster < 0:
        raise ValueError(f"tile_trsv takes no m = {m} in {dtype}")
    return {"cluster": cluster, "variant": "resident" if resident else "streaming", "smem_bytes": smem}


def tile_gemv_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the GEMV kernel on strided (Z, G, Q, m, n) tiles and (Z, G, Q, n) vectors."""
    _check("tile_gemv", a, x)
    if a.ndim != 5 or x.ndim != 4 or tuple(x.shape) != tuple(a.shape[:3]) + (a.shape[4],):
        raise ValueError(f"tile_gemv takes a (Z, G, Q, m, n) and x (Z, G, Q, n), got {tuple(a.shape)}, "
                         f"{tuple(x.shape)}")
    z, g, q, m, n = a.shape
    out = torch.empty((z, g, m), dtype=a.dtype, device=a.device)
    lib = _build.load("tile_gemv_trsv")
    fn = lib.tile_gemv_f32 if a.dtype == torch.float32 else lib.tile_gemv_f64
    code = fn(a.data_ptr(), x.data_ptr(), out.data_ptr(), z, g, q, m, n, _strides(*a.stride()),
              _strides(*x.stride()), a.device.index, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, "tile_gemv")
    return out


def tile_trsv_cuda(l: torch.Tensor, r: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Launch the solve kernel: (Z, G, m, m) tiles with rows of stride m, (Z, G, m) vectors of stride 1."""
    _check("tile_trsv", l, r)
    if l.ndim != 4 or r.ndim != 3 or tuple(r.shape) != tuple(l.shape[:3]) or l.shape[2] != l.shape[3]:
        raise ValueError(f"tile_trsv takes l (Z, G, m, m) and r (Z, G, m), got {tuple(l.shape)}, {tuple(r.shape)}")
    z, g, m, _ = l.shape
    trsv_plan(m, l.dtype)  # raises past the streaming variant's sizes, before a copy of l
    if l.stride()[2:] != (m, 1):
        l = l.contiguous()
    if r.stride(2) != 1:
        r = r.contiguous()
    out = torch.empty((z, g, m), dtype=l.dtype, device=l.device)
    lib = _build.load("tile_gemv_trsv")
    fn = lib.tile_trsv_f32 if l.dtype == torch.float32 else lib.tile_trsv_f64
    code = fn(l.data_ptr(), r.data_ptr(), out.data_ptr(), z, g, m,
              _strides(l.stride(0), l.stride(1), r.stride(0), r.stride(1)), int(transpose), l.device.index,
              torch.cuda.current_stream(l.device).cuda_stream)
    _build.check(lib, code, "tile_trsv")
    return out
