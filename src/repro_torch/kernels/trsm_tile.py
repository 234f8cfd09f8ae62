"""Tile triangular solve X L^T = B (TRSM): the CUDA kernel and its plain version.

Replaces ``repro/kernels/trsm_tile.py::_trsm_kernel``.  The executor solves
every panel task of a level against its own diagonal factor L_JJ, so the
kernel takes a (G, m, m) stack of L beside the (G, m, m) stack of B.  The
Pallas kernel computes in float32 even for float64 operands; this port keeps
the operand type (float32 or float64) in the kernel and in the plain version.

On the card a call is two launches of the strip solve that the carry kernel
shares (``csrc/strip_solve.cuh``): a prep that writes L transposed and the
inverses of its 32 x 32 diagonal blocks into workspace tensors, then one CTA
per strip of rows of B, solved right-looking in shared memory.  The launcher
takes the tallest strip (32, 16 or 8 rows in float32, 16 or 8 in float64)
whose grid still covers the card's SMs, so a launch of one tile runs 8-row
strips on 64 CTAs at m = 512.  Tiles run up to m = 6816 (float32) and 3168
(float64), the strip solve's range; past that the wrapper raises
``ValueError``.  The source, with what bounds it on the H100 and what the
design does about it, is ``csrc/trsm_tile.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.carry_update import check_strip_limit, strip_workspace


def trsm_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve X_g L_g^T = B_g for (G, m, m) stacks by the column recurrence.

    Column j of X is ``(B[:, j] - X[:, :j] @ L[j, :j]) / L[j, j]``, the
    recurrence the Pallas kernel runs.
    """
    x = torch.empty_like(b)
    for j in range(b.shape[-1]):
        s = (x[..., :, :j] @ l[..., j, :j, None])[..., 0]
        x[..., :, j] = (b[..., :, j] - s) / l[..., j, j, None]
    return x


def trsm_cuda(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on (G, m, m) stacks of L and B."""
    if l.device != b.device or l.device.type != "cuda":
        raise ValueError(f"trsm_cuda needs L and B on one CUDA device: {l.device}, {b.device}")
    if l.dtype not in (torch.float32, torch.float64) or b.dtype != l.dtype:
        raise TypeError(f"trsm takes float32 or float64 tiles of one type, got {l.dtype}/{b.dtype}")
    if l.ndim != 3 or l.shape != b.shape or l.shape[1] != l.shape[2]:
        raise ValueError(f"trsm takes two (G, m, m) stacks, got {tuple(l.shape)}, {tuple(b.shape)}")
    if not (l.is_contiguous() and b.is_contiguous()):
        raise ValueError("trsm takes contiguous stacks")
    g, m = b.shape[0], b.shape[1]
    f64 = b.dtype == torch.float64
    lib = _build.load("trsm_tile")
    check_strip_limit("trsm", m, lib.trsm_max_m(int(f64)), b.dtype)
    out = torch.empty_like(b)
    lt, dt = strip_workspace(l)
    vec = m % (16 // b.element_size()) == 0 and all(t.data_ptr() % 16 == 0 for t in (l, b, out))
    fn = lib.trsm_f64 if f64 else lib.trsm_f32
    code = fn(
        l.data_ptr(), b.data_ptr(), lt.data_ptr(), dt.data_ptr(), out.data_ptr(), g, m, int(vec),
        b.device.index, torch.cuda.current_stream(b.device).cuda_stream,
    )
    _build.check(lib, code, "trsm")
    return out
