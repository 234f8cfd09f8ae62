"""Batched trailing update O = C - A B^T: the CUDA kernel and its plain version.

Replaces ``repro/kernels/trailing_update.py::_update_kernel``.  One launch
covers every SYRK and GEMM task of a level (SYRK passes the same panel tile
as A and B).  Products accumulate in float32 for float32 and bfloat16
operands and in float64 for float64; with ``update_dtype=bfloat16`` only A
and B are bfloat16, C and the result keep the storage type.  The kernel is
a register-blocked SIMT product in IEEE FMA (never TF32): 128 x 128 output
tiles per 256-thread CTA (64 x 64 for float64), each thread 8 x 8 (4 x 4)
accumulators, two-stage pipelined loads.  :func:`trail_variant` picks
64 x 64 tiles (32 x 32 for float64) for launches of fewer big tiles than
half the card's SMs, and the scalar-load instantiation when rows are not
16-byte aligned (m not a multiple of 16 / sizeof(operand)).  The source,
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


# a launch of fewer big tiles than half the H100's 132 SMs takes small ones
# (measured at m = 512: small tiles win at G <= 4, big ones from G = 8)
SMALL_LAUNCH_TILES = 66


def trail_variant(g: int, m: int, operand_dtype: torch.dtype) -> tuple:
    """(big, vec) of the launch: big output tiles (128 x 128; 64 x 64 for
    float64) unless ``g`` tasks make fewer of them than half the card's SMs,
    and 16-byte loads when m allows them."""
    edge = 64 if operand_dtype == torch.float64 else 128  # the big tile's edge
    big = g * (-(-m // edge)) ** 2 >= SMALL_LAUNCH_TILES
    vec = m % (16 // operand_dtype.itemsize) == 0
    return big, vec


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
    big, vec = trail_variant(c.shape[0], c.shape[1], a.dtype)
    vec = vec and all(t.data_ptr() % 16 == 0 for t in (c, a, b, out))
    lib = _build.load("trailing_update")
    code = getattr(lib, name)(
        c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), c.shape[0], c.shape[1], int(big), int(vec),
        c.device.index, torch.cuda.current_stream(c.device).cuda_stream,
    )
    _build.check(lib, code, "trail")
    return out
