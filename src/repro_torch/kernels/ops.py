"""Per-stack tile ops of the executor, dispatched by device.

Each op takes the whole gathered stack of a level, ``(G, m, m)`` (the JAX
executor vmaps a per-tile op; here the batch axis is written out):

* ``potrf(a)``             — lower Cholesky factors;
* ``trsm(l, b)``           — X L^T = B with a per-task L;
* ``trail(c, a, b)``       — C - A B^T, the fused SYRK + GEMM launch;
* ``cov_tiles(...)``       — masked covariance tiles (ASSEMBLE/CROSS/PRIOR,
  and UASM/UASMD of the append);
* ``carry_update(w, l, y, c)`` — (W - L Y) C^{-T}, the UCARRY step of the
  rank update;
* ``lrgemm(kflat, v, a, b)`` — the tile matvecs ``kflat[a[g]] @ v[b[g]]``
  of the low-rank tier's LRGEMM family, read where the tiles lie.

On a CUDA tensor an op launches its hand-written kernel or raises; on a CPU
tensor it runs the kernel's plain version.  No ``try`` falls back from one
to the other.  Each op carries a plain integer ``launches`` that it bumps
where it launches its kernel, and nowhere else, so a run can show that it
went through the kernels (:func:`launch_counts`).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import carry_update as _carry
from repro_torch.kernels import cov_assembly as _cov
from repro_torch.kernels import lrgemm_tile as _lrgemm
from repro_torch.kernels import potrf_tile as _potrf
from repro_torch.kernels import trailing_update as _trail
from repro_torch.kernels import trsm_tile as _trsm


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel or plain version for device {t.device}")


def potrf(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (G, m, m) stack."""
    if not _on_cuda(a, "potrf"):
        return _potrf.potrf_plain(a)
    out = _potrf.potrf_cuda(a)
    potrf.launches += 1
    return out


def trsm(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X with X L^T = B for (G, m, m) stacks of L and B."""
    if not _on_cuda(b, "trsm"):
        return _trsm.trsm_plain(l, b)
    out = _trsm.trsm_cuda(l, b)
    trsm.launches += 1
    return out


def trail(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, update_dtype=None) -> torch.Tensor:
    """C - A B^T for (G, m, m) stacks; ``update_dtype`` casts A and B only."""
    if update_dtype is not None:
        a, b = a.to(update_dtype), b.to(update_dtype)
    if not _on_cuda(c, "trail"):
        return _trail.trail_plain(c, a, b)
    out = _trail.trail_cuda(c, a, b)
    trail.launches += 1
    return out


def cov_tiles(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None
) -> torch.Tensor:
    """(T, m, D) x (T, mb, D) -> (T, m, mb) masked covariance tiles.

    ``row0``/``col0`` are the tiles' global row/column offsets and
    ``n_valid_r``/``n_valid_c`` the valid row/column counts (scalars or
    (T,) tensors).  Symmetric tiles pin the global diagonal to
    ``diag + noise`` and are identity past the valid region; cross tiles
    are zero there.
    """
    if not _on_cuda(xa, "cov_tiles"):
        return _cov.cov_tiles_plain(
            xa, xb, row0, col0, n_valid_r, n_valid_c, params,
            symmetric=symmetric, kernel=kernel,
        )
    out = _cov.cov_tiles_cuda(
        xa, xb, row0, col0, n_valid_r, n_valid_c, params,
        symmetric=symmetric, kernel=kernel,
    )
    cov_tiles.launches += 1
    return out


def carry_update(w: torch.Tensor, l: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(W - L Y) C^{-T} for (G, m, m) stacks (the fused UCARRY step)."""
    if not _on_cuda(w, "carry_update"):
        return _carry.carry_update_plain(w, l, y, c)
    out = _carry.carry_update_cuda(w, l, y, c)
    carry_update.launches += 1
    return out


def lrgemm(kflat: torch.Tensor, v: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """(G, m) tile matvecs ``kflat[a[g]] @ v[b[g]]`` of (T, m, mb) tiles and (M, mb) chunks."""
    if not _on_cuda(kflat, "lrgemm"):
        return _lrgemm.lrgemm_plain(kflat, v, a_idx, b_idx)
    out = _lrgemm.lrgemm_cuda(kflat, v, a_idx, b_idx)
    lrgemm.launches += 1
    return out


KERNEL_OPS = {
    "cov_tiles": cov_tiles, "potrf": potrf, "trsm": trsm, "trail": trail,
    "carry_update": carry_update, "lrgemm": lrgemm,
}
for _op in KERNEL_OPS.values():
    _op.launches = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def reset_launch_counts() -> None:
    for op in KERNEL_OPS.values():
        op.launches = 0
