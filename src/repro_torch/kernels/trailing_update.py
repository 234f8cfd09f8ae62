"""Batched trailing update O = C - A B^T: the CUDA kernel and its plain version.

Replaces ``repro/kernels/trailing_update.py::_update_kernel``.  One launch
covers every SYRK and GEMM task of a level (SYRK passes the same panel tile
as A and B).  Products accumulate in float32 for float32 and bfloat16
operands and in float64 for float64; with ``update_dtype=bfloat16`` only A
and B are bfloat16, C and the result keep the storage type.  The source,
with what bounds it on the H100 and what the design does about it, is
``csrc/trailing_update.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# (operand dtype, storage dtype) -> launcher name
_LAUNCHERS = {
    (torch.float32, torch.float32): "trail_f32",
    (torch.bfloat16, torch.float32): "trail_bf16",
    (torch.float64, torch.float64): "trail_f64",
}


def trail_plain(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C - A B^T for (G, m, m) stacks, accumulated in float32 or wider."""
    acc = torch.promote_types(a.dtype, torch.float32)
    upd = a.to(acc) @ b.to(acc).transpose(-1, -2)
    return (c.to(acc) - upd).to(c.dtype)


def trail_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on (G, m, m) stacks C, A and B."""
    name = _LAUNCHERS.get((a.dtype, c.dtype))
    if name is None or b.dtype != a.dtype:
        raise TypeError(
            f"trail takes (operands, storage) in {sorted((str(k[0]), str(k[1])) for k in _LAUNCHERS)}, "
            f"got A {a.dtype}, B {b.dtype}, C {c.dtype}"
        )
    if not (c.device == a.device == b.device) or c.device.type != "cuda":
        raise ValueError(f"trail_cuda needs C, A, B on one CUDA device: {c.device}, {a.device}, {b.device}")
    if c.ndim != 3 or c.shape != a.shape or c.shape != b.shape or c.shape[1] != c.shape[2]:
        raise ValueError(f"trail takes three (G, m, m) stacks, got {tuple(c.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    if not (c.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("trail takes contiguous stacks")
    out = torch.empty_like(c)
    lib = _build.load("trailing_update")
    code = getattr(lib, name)(
        c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), c.shape[0], c.shape[1],
        c.device.index, torch.cuda.current_stream(c.device).cuda_stream,
    )
    _build.check(lib, code, "trail")
    return out
