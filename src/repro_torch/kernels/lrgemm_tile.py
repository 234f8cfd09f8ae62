"""Low-rank contraction tiles (LRGEMM): the CUDA kernel and its plain version.

Replaces ``repro/kernels/lrgemm_tile.py::_lrgemm_kernel``.  The n-side work
of the Nystrom inner system, ``c_p = sum_j K_un[p, j] y_j``, is a stack of
independent tile matvecs; one launch covers every task of a plan:
``out[g] = kflat[a[g]] @ v[b[g]]``.  The kernel takes the flat tile grid,
the chunk stack and the plan's index vectors and reads the tiles where they
lie, so the K_un grid (2 GiB at gp_256k) is never gathered into a copy; the
plain version gathers, then contracts.  ``mb`` may differ from ``m``.

On the card one block of 8 warps takes 8 rows of a task, the blocks in the
order of the rows in memory; rows on 16-byte boundaries are read as 16-byte
vectors, an odd ``mb`` one element a lane.  Precision: float32 operands sum in IEEE float32, as the
Pallas body does; float64 operands stay float64, where the Pallas body casts
them to float32.  The source, with what bounds it on the H100 and what the
design does about it, is ``csrc/lrgemm_tile.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def lrgemm_plain(
    kflat: torch.Tensor, v: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor
) -> torch.Tensor:
    """(T, m, mb) tiles and (M, mb) chunks -> (G, m): ``kflat[a[g]] @ v[b[g]]``.

    Computed in the input type promoted to float32, returned in kflat's type.
    """
    dt = torch.promote_types(kflat.dtype, torch.float32)
    a = kflat.index_select(0, a_idx).to(dt)
    x = v.index_select(0, b_idx).to(dt)
    return torch.einsum("gab,gb->ga", a, x).to(kflat.dtype)


def lrgemm_cuda(
    kflat: torch.Tensor, v: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel: contiguous (T, m, mb) tiles, (M, mb) chunks, int64 (G,) indices."""
    if kflat.dtype not in (torch.float32, torch.float64) or v.dtype != kflat.dtype:
        raise TypeError(f"lrgemm takes float32 or float64 operands of one type, got {kflat.dtype}/{v.dtype}")
    if a_idx.dtype != torch.int64 or b_idx.dtype != torch.int64:
        raise TypeError(f"lrgemm takes int64 index vectors, got {a_idx.dtype}/{b_idx.dtype}")
    if not (kflat.device == v.device == a_idx.device == b_idx.device) or kflat.device.type != "cuda":
        raise ValueError(
            f"lrgemm_cuda needs every operand on one CUDA device: {kflat.device}, {v.device}, "
            f"{a_idx.device}, {b_idx.device}"
        )
    if (
        kflat.ndim != 3 or v.ndim != 2 or v.shape[1] != kflat.shape[2]
        or a_idx.ndim != 1 or a_idx.shape != b_idx.shape
    ):
        raise ValueError(
            f"lrgemm takes (T, m, mb) tiles, (M, mb) chunks and two (G,) index vectors, got "
            f"{tuple(kflat.shape)}, {tuple(v.shape)}, {tuple(a_idx.shape)}, {tuple(b_idx.shape)}"
        )
    if not all(t.is_contiguous() for t in (kflat, v, a_idx, b_idx)):
        raise ValueError("lrgemm takes contiguous operands")
    n_a, m, mb = kflat.shape
    g = a_idx.shape[0]
    out = torch.empty((g, m), dtype=kflat.dtype, device=kflat.device)
    width = 16 // kflat.element_size()  # elements of one 16-byte vector load
    # rows of A and of v on 16-byte boundaries: the kernel's vector loads
    vec = mb % width == 0 and kflat.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    lib = _build.load("lrgemm_tile")
    fn = lib.lrgemm_f32 if kflat.dtype == torch.float32 else lib.lrgemm_f64
    code = fn(
        kflat.data_ptr(), v.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(), out.data_ptr(),
        g, m, mb, n_a, v.shape[0], int(vec),
        kflat.device.index, torch.cuda.current_stream(kflat.device).cuda_stream,
    )
    _build.check(lib, code, "lrgemm")
    return out
