"""Tile triangular solve X L^T = B (TRSM): the CUDA kernel and its plain version.

Replaces ``repro/kernels/trsm_tile.py::_trsm_kernel``.  The executor solves
every panel task of a level against its own diagonal factor L_JJ, so the
kernel takes a (G, m, m) stack of L beside the (G, m, m) stack of B.  The
Pallas kernel computes in float32 even for float64 operands; this port keeps
the operand type (float32 or float64) in the kernel and in the plain version.
The source, with what bounds it on the H100 and what the design does about
it, is ``csrc/trsm_tile.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
    out = torch.empty_like(b)
    lib = _build.load("trsm_tile")
    fn = lib.trsm_f32 if b.dtype == torch.float32 else lib.trsm_f64
    code = fn(
        l.data_ptr(), b.data_ptr(), out.data_ptr(), b.shape[0], b.shape[1],
        b.device.index, torch.cuda.current_stream(b.device).cuda_stream,
    )
    _build.check(lib, code, "trsm")
    return out
