"""Tile Cholesky factorization (POTRF): the CUDA kernel and its plain version.

Replaces ``repro/kernels/potrf_tile.py::_potrf_kernel``.  Takes a (G, m, m)
stack of SPD tiles in one launch and returns the lower factors.  float64 is
kept.  A non-positive pivot gives NaN, as ``jnp.sqrt`` does; nothing raises,
so callers can detect a failed factorization from the values.  The kernel
runs each tile's blocked Cholesky DAG across the card, one CTA per
``BLOCK`` x ``BLOCK`` lower block; the source, with what bounds it on the
H100 and what the design does about it, is ``csrc/potrf_tile.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

BLOCK = 32  # the kernel's block edge, NB in csrc/potrf_tile.cu


def potrf_plain(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (G, m, m) stack, unblocked and right-looking.

    One rank-1 update per column, as the Pallas kernel does; computed in the
    input type (float32 or wider).
    """
    a = a.to(torch.promote_types(a.dtype, torch.float32)).clone()
    n = a.shape[-1]
    for j in range(n):
        piv = torch.sqrt(a[..., j, j])
        col = a[..., j + 1 :, j] / piv[..., None]
        a[..., j, j] = piv
        a[..., j + 1 :, j] = col
        a[..., j + 1 :, j + 1 :] -= col[..., :, None] * col[..., None, :]
    return torch.tril(a)


def potrf_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a (G, m, m) stack (float32 or float64)."""
    if a.device.type != "cuda":
        raise ValueError(f"potrf_cuda needs a CUDA tensor, got {a.device}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"potrf takes float32 or float64 tiles, got {a.dtype}")
    if a.ndim != 3 or a.shape[1] != a.shape[2] or not a.is_contiguous():
        raise ValueError(f"potrf takes a contiguous (G, m, m) stack, got {tuple(a.shape)}")
    g, m = a.shape[0], a.shape[1]
    t = -(-m // BLOCK)
    out = torch.empty_like(a)
    # scratch: the factor's blocks as the consumers read them, and the ticket
    # counter followed by one ready flag per block, zeroed for every call.
    # Freed on return: the caching allocator hands the memory out again only
    # in the order of this stream, so after the kernel.
    work = torch.empty(g * t * (t + 1) // 2 * BLOCK * BLOCK, dtype=a.dtype, device=a.device)
    sync = torch.zeros(1 + g * t * t, dtype=torch.int32, device=a.device)
    lib = _build.load("potrf_tile")
    fn = lib.potrf_f32 if a.dtype == torch.float32 else lib.potrf_f64
    code = fn(
        a.data_ptr(), out.data_ptr(), work.data_ptr(), sync.data_ptr(), g, m,
        a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(lib, code, "potrf")
    return out
