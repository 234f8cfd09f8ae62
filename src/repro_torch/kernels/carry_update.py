"""Fused carry transform of the rank update, (W - L Y) C^{-T}: the CUDA kernel and its plain version.

Replaces ``repro/kernels/downdate_tile.py::_carry_kernel``.  The blocked
cholupdate sweep rewrites every sub-diagonal carry block once per column,
``W_i <- (W_i - L'(i,j) Y_j) C_j^{-T}``: one (m x m) product, then a right
triangular solve against the lower correction factor C_j.  One call covers
every UCARRY task of a level, on (G, m, m) stacks.  The product is ``L Y``,
not ``L Y^T`` as in the trailing update.  float32 and float64 are kept.

On the card a call is two launches: ``carry_prep`` writes C transposed and
the inverses of its 32 x 32 diagonal blocks into workspace tensors, then
``carry_kernel`` forms a strip of W - L Y in shared memory and solves it
right-looking, both on the register-blocked product core shared with the
trailing update.  The strip is 32 rows (float32) or 16 (float64) wherever it
fits, as at m = 512, where two CTAs share an SM; a larger tile takes a
shorter strip (16, then 8 rows for float32; 8 for float64), which takes m up
to 6816 (float32) and 3168 (float64).  Past that, the wrapper raises
``ValueError``.  The source,
with what bounds it on the H100 and what the design does about it, is
``csrc/carry_update.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def carry_update_plain(w: torch.Tensor, l: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(W - L Y) C^{-T} for (G, m, m) stacks, in the input type promoted to float32.

    ``b = w - l @ y``, then the column recurrence of the Pallas body:
    ``X[:, j] = (B[:, j] - X[:, :j] @ C[j, :j]) / C[j, j]``.
    """
    dt = torch.promote_types(w.dtype, torch.float32)
    l, y, c = l.to(dt), y.to(dt), c.to(dt)
    b = w.to(dt) - l @ y
    x = torch.empty_like(b)
    for j in range(b.shape[-1]):
        s = (x[..., :, :j] @ c[..., j, :j, None])[..., 0]
        x[..., :, j] = (b[..., :, j] - s) / c[..., j, j, None]
    return x.to(w.dtype)


def check_strip_limit(op: str, m: int, limit: int, dtype) -> None:
    """Refuse a tile past the strip solve's range (``csrc/strip_solve.cuh``) before any launch."""
    if m > limit:
        raise ValueError(
            f"{op} takes tiles up to m = {limit} in {dtype} (the shortest strip of rows must fit in shared "
            f"memory), got m = {m}"
        )


def strip_workspace(c: torch.Tensor):
    """The strip solve's workspace for a (G, m, m) stack of factors C: C transposed, and the inverse of
    each 32 x 32 diagonal block, transposed."""
    g, m = c.shape[0], c.shape[1]
    return torch.empty_like(c), torch.empty((g, -(-m // 32), 32, 32), dtype=c.dtype, device=c.device)


def carry_update_cuda(w: torch.Tensor, l: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous (G, m, m) stacks W, L, Y and C."""
    if w.dtype not in (torch.float32, torch.float64) or not (w.dtype == l.dtype == y.dtype == c.dtype):
        raise TypeError(
            f"carry_update takes float32 or float64 stacks of one type, got "
            f"{w.dtype}/{l.dtype}/{y.dtype}/{c.dtype}"
        )
    if not (w.device == l.device == y.device == c.device) or w.device.type != "cuda":
        raise ValueError(
            f"carry_update_cuda needs W, L, Y, C on one CUDA device: "
            f"{w.device}, {l.device}, {y.device}, {c.device}"
        )
    if w.ndim != 3 or w.shape[1] != w.shape[2] or not (w.shape == l.shape == y.shape == c.shape):
        raise ValueError(
            f"carry_update takes four (G, m, m) stacks, got {tuple(w.shape)}, {tuple(l.shape)}, "
            f"{tuple(y.shape)}, {tuple(c.shape)}"
        )
    if not all(t.is_contiguous() for t in (w, l, y, c)):
        raise ValueError("carry_update takes contiguous stacks")
    g, m = w.shape[0], w.shape[1]
    f64 = w.dtype == torch.float64
    lib = _build.load("carry_update")
    check_strip_limit("carry_update", m, lib.carry_update_max_m(int(f64)), w.dtype)
    out = torch.empty_like(w)
    ct, dt = strip_workspace(c)
    vec = m % (16 // w.element_size()) == 0 and all(t.data_ptr() % 16 == 0 for t in (w, l, y, c, out))
    fn = lib.carry_update_f64 if f64 else lib.carry_update_f32
    code = fn(
        w.data_ptr(), l.data_ptr(), y.data_ptr(), c.data_ptr(), ct.data_ptr(), dt.data_ptr(), out.data_ptr(),
        g, m, int(vec), w.device.index, torch.cuda.current_stream(w.device).cuda_stream,
    )
    _build.check(lib, code, "carry_update")
    return out
