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
  of the low-rank tier's LRGEMM family, read where the tiles lie;
* ``tile_gemv(a, x)``, ``tile_trsv(l, r, transpose)`` — a fleet's tile
  matvecs and diagonal-tile solves, batch-invariant (port-only kernels: the
  reference leaves these steps to XLA);
* ``flash_attention(q, k, v, ...)`` — causal GQA attention with softcap and
  sliding window, the language model's prefill and training attention (not
  a tile op).

On a CUDA tensor an op launches its hand-written kernel or raises; on a CPU
tensor it runs the kernel's plain version.  No ``try`` falls back from one
to the other.  Each op carries a plain integer ``launches`` that it bumps
where it launches its kernel, and nowhere else, so a run can show that it
went through the kernels (:func:`launch_counts`); ``cov_tiles``' count is
``cov_assembly.cov_tiles_cuda.launches``, bumped per launch, since a
composite that mixes distances launches once per distance.

Gradients, as the reference's ``_with_ref_vjp`` keeps them: when grad mode
is on and an operand requires grad, ``potrf``, ``trsm``, ``trail``,
``lrgemm``, ``cov_tiles``, ``tile_gemv``, ``tile_trsv`` and ``flash_attention`` run through
:class:`_RefGrad`, whose forward is the kernel (the plain version on the
CPU) and whose backward differentiates the op's differentiable reference
(:data:`GRAD_REFS`; for ``cov_tiles`` the plain tile, since the kernel reads
the hyperparameters detached, from its descriptor table; every tensor leaf
of the params tree is an operand; for ``flash_attention`` the caller's
``ref``, by default the plain version) on the saved inputs.  Otherwise they
launch exactly as without autograd.  The reference gives the flash kernel
no backward: its training attention is XLA's autodiff of the masked
softmax, which is what the language model passes as ``ref``.
``carry_update`` has no backward in the reference: on the card it raises
rather than return a detached result.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import kernels_math as km
from repro_torch.kernels import carry_update as _carry
from repro_torch.kernels import cov_assembly as _cov
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import lrgemm_tile as _lrgemm
from repro_torch.kernels import potrf_tile as _potrf
from repro_torch.kernels import tile_gemv_trsv as _gemv
from repro_torch.kernels import trailing_update as _trail
from repro_torch.kernels import trsm_tile as _trsm


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel or plain version for device {t.device}")


def _wants_grad(*operands) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in operands
    )


def _potrf_ref(a):
    return torch.linalg.cholesky(a)


def _trsm_ref(l, b):
    return torch.linalg.solve_triangular(l.mT, b, upper=True, left=False)


# The differentiable function each op's backward differentiates: the
# reference's jnp tile ops (``_potrf_ref``, ``_trsm_ref``, the SYRK/GEMM
# matmuls and ``a @ v``).  The plain POTRF and TRSM loops write into their
# own outputs in place, which autograd cannot go back through, so those two
# take the torch.linalg functions the reference takes.
GRAD_REFS = {
    "potrf": _potrf_ref,
    "trsm": _trsm_ref,
    "trail": _trail.trail_plain,
    "lrgemm": _lrgemm.lrgemm_plain,
}


class _RefGrad(torch.autograd.Function):
    """Forward: ``kernel(*args)``; backward: autograd of ``ref`` on the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, ref, *args):
        ctx.ref = ref
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n) for a, n in zip(ctx.saved_tensors, needs)]
            wrt = [a for a, n in zip(args, needs) if n]
            got = iter(torch.autograd.grad(ctx.ref(*args), wrt, grad, allow_unused=True))
        return (None, None, *(next(got) if n else None for n in needs))


def _run(name: str, kernel, *args, ref=None):
    """``kernel(*args)``, through :class:`_RefGrad` when an operand needs a gradient.

    The backward differentiates ``ref``, by default ``GRAD_REFS[name]``.
    """
    if _wants_grad(*args):
        return _RefGrad.apply(kernel, ref or GRAD_REFS[name], *args)
    return kernel(*args)


def _no_backward(op: str, *operands) -> None:
    if _wants_grad(*operands):
        raise RuntimeError(
            f"{op} has no backward (the reference gives it none): call it under "
            "torch.no_grad() or on operands that do not require grad"
        )


def potrf(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (G, m, m) stack."""
    if not _on_cuda(a, "potrf"):
        return _run("potrf", _potrf.potrf_plain, a)
    out = _run("potrf", _potrf.potrf_cuda, a)
    potrf.launches += 1
    return out


def trsm(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X with X L^T = B for (G, m, m) stacks of L and B."""
    if not _on_cuda(b, "trsm"):
        return _run("trsm", _trsm.trsm_plain, l, b)
    out = _run("trsm", _trsm.trsm_cuda, l, b)
    trsm.launches += 1
    return out


def trail(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, update_dtype=None) -> torch.Tensor:
    """C - A B^T for (G, m, m) stacks; ``update_dtype`` casts A and B only."""
    if update_dtype is not None:
        a, b = a.to(update_dtype), b.to(update_dtype)
    if not _on_cuda(c, "trail"):
        return _trail.trail_plain(c, a, b)
    out = _run("trail", _trail.trail_cuda, c, a, b)
    trail.launches += 1
    return out


def cov_descriptor(kernel, params, d: int, dtype: torch.dtype, device):
    """The kernel tree's descriptor for ``cov_tiles`` launches on ``device`` (None on the CPU).

    A program run builds it once and passes it to each of its ``cov_tiles``
    calls (``table=``), so that the hyperparameters' table is not rebuilt a launch.
    """
    if torch.device(device).type != "cuda":
        return None
    return km.descriptor_table(kernel, params, d, dtype, device)


def cov_tiles(
    xa, xb, row0, col0, n_valid_r, n_valid_c, params, *, symmetric: bool, kernel=None, table=None
) -> torch.Tensor:
    """(T, m, D) x (T, mb, D) -> (T, m, mb) masked covariance tiles.

    ``row0``/``col0`` are the tiles' global row/column offsets and
    ``n_valid_r``/``n_valid_c`` the valid row/column counts (scalars or
    (T,) tensors).  Symmetric tiles pin the global diagonal to
    ``diag + noise`` and are identity past the valid region; cross tiles
    are zero there.  Per-problem params (leaves (P,) + base) take T = P * G
    tiles, problem-major; ``table`` is their descriptor
    (:func:`cov_descriptor`), built once per program run, or None.
    """
    if not _on_cuda(xa, "cov_tiles"):
        return _cov.cov_tiles_plain(
            xa, xb, row0, col0, n_valid_r, n_valid_c, params,
            symmetric=symmetric, kernel=kernel,
        )
    # every tensor leaf of the params tree, at any depth, is an operand of _RefGrad; the rest stay bound
    split = km.TensorLeaves(params)

    def bound(fn, **extra):
        def tiles(xa, xb, *values):
            p = split.rebuild(values)
            return fn(xa, xb, row0, col0, n_valid_r, n_valid_c, p, symmetric=symmetric, kernel=kernel, **extra)
        return tiles

    # the launches are counted where they happen, in cov_assembly (one per distance of a mixed composite)
    extra = {} if table is None else {"table": table}
    return _run("cov_tiles", bound(_cov.cov_tiles_cuda, **extra), xa, xb, *split.values(),
                ref=bound(_cov.cov_tiles_plain))


def carry_update(w: torch.Tensor, l: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(W - L Y) C^{-T} for (G, m, m) stacks (the fused UCARRY step)."""
    if not _on_cuda(w, "carry_update"):
        return _carry.carry_update_plain(w, l, y, c)
    _no_backward("carry_update", w, l, y, c)
    out = _carry.carry_update_cuda(w, l, y, c)
    carry_update.launches += 1
    return out


def lrgemm(kflat: torch.Tensor, v: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """(G, m) tile matvecs ``kflat[a[g]] @ v[b[g]]`` of (T, m, mb) tiles and (M, mb) chunks."""
    if not _on_cuda(kflat, "lrgemm"):
        return _lrgemm.lrgemm_plain(kflat, v, a_idx, b_idx)
    out = _run("lrgemm", _lrgemm.lrgemm_cuda, kflat, v, a_idx, b_idx)
    lrgemm.launches += 1
    return out


def tile_gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Z, G, m): ``sum_q a[z, g, q] @ x[z, g, q]`` of (Z, G, Q, m, n) tiles and (Z, G, Q, n) vectors."""
    if not _on_cuda(a, "tile_gemv"):
        return _gemv.tile_gemv_plain(a, x)
    out = _run("tile_gemv", _gemv.tile_gemv_cuda, a, x, ref=_gemv.tile_gemv_plain)
    tile_gemv.launches += 1
    return out


def tile_trsv(l: torch.Tensor, r: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """(Z, G, m): ``l^-1 r`` (or ``l^-T r``) of (Z, G, m, m) lower tiles and (Z, G, m) vectors."""
    if not _on_cuda(l, "tile_trsv"):
        return _gemv.tile_trsv_plain(l, r, transpose)
    out = _run("tile_trsv", lambda l, r: _gemv.tile_trsv_cuda(l, r, transpose), l, r,
               ref=lambda l, r: _gemv.tile_trsv_plain(l, r, transpose))
    tile_trsv.launches += 1
    return out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, softcap=None, window=None,
    ref=None,
) -> torch.Tensor:
    """(B, S, H, hd) attention of q over (B, T, KV, hd) keys and values, in q's type.

    Under grad the backward differentiates ``ref(q, k, v)`` (default: the
    plain version with the same options) on the saved q, k, v; the forward
    is the kernel on the card whatever ``ref`` is.
    """
    def kernel_of(fn):
        return lambda q, k, v: fn(q, k, v, causal=causal, softcap=softcap, window=window)

    ref = ref or kernel_of(_flash.flash_attention_plain)
    if not _on_cuda(q, "flash_attention"):
        return _run("flash_attention", kernel_of(_flash.flash_attention_plain), q, k, v, ref=ref)
    out = _run("flash_attention", kernel_of(_flash.flash_attention_cuda), q, k, v, ref=ref)
    flash_attention.launches += 1
    return out


# what holds each kernel's count: the op, or for cov_tiles the CUDA wrapper, which may launch more than once a call
KERNEL_OPS = {
    "cov_tiles": _cov.cov_tiles_cuda, "potrf": potrf, "trsm": trsm, "trail": trail,
    "carry_update": carry_update, "lrgemm": lrgemm, "flash_attention": flash_attention,
    "tile_gemv": tile_gemv, "tile_trsv": tile_trsv,
}
for _op in KERNEL_OPS.values():
    _op.launches = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def reset_launch_counts() -> None:
    for op in KERNEL_OPS.values():
        op.launches = 0
