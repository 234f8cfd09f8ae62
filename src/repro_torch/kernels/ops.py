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
to the other.  On a ``meta`` tensor (the launch tools' dry-run, which holds
no data) an op returns an empty tensor of its kernel's output shape and
type and computes nothing: the shape-only route, which only a meta tensor
reaches.  :func:`_dispatch` picks the route.  Each op carries a plain
integer ``launches`` that it bumps where it launches its kernel on the
card, and nowhere else, so a run can show that it went through the kernels
(:func:`launch_counts`); ``cov_tiles``' count is
``cov_assembly.cov_tiles_cuda.launches``, bumped per launch, since a
composite that mixes distances launches once per distance.

Inside :func:`counting` every call of every op, whatever its route, adds to
the count it yields the launches its kernel makes on the card and its
operations and bytes (:func:`kernel_cost`: the formulas of PERF.md's
bounds), and runs its route with torch's dispatch modes set aside, so that a
``FlopCounterMode`` or a byte counter around it counts the kernel once, by
its formula, and not the plain version's ops: the count is the same on the
card, on the CPU and on meta tensors, and on the card its launches equal
what :func:`launch_counts` shows.

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

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

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


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    """The meta route's result: an empty meta tensor (nothing computed)."""
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# The counting scope: each kernel's operations and bytes, whatever the route.
# ---------------------------------------------------------------------------


def _clamped_sum(s: int, c: int, t: int) -> int:
    """sum over 0 <= i < s of clamp(i + c, 0, t)."""
    a, b = max(0, -c), min(s, t - c)  # i + c runs linearly over [a, b)
    linear = (b - a) * (a + b - 1 + 2 * c) // 2 if b > a else 0
    return linear + t * max(0, s - max(0, t - c))


def attention_pairs(s: int, t: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the flash kernel's mask keeps: key j < t for query i < s if j <= i (causal, top-left
    aligned) and j > i - window (a window), in closed form."""
    kept = _clamped_sum(s, 1, t) if causal else s * t
    return kept - (0 if window is None else _clamped_sum(s, 1 - window, t))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def kernel_cost(name: str, args: tuple, out: torch.Tensor, **kw) -> tuple:
    """(operations, bytes) of one call of kernel ``name`` on ``args`` giving ``out``.

    Bytes: every tensor operand read once and the result written once.
    Operations, the formulas of PERF.md's bounds: TRAIL 2·m·mb·k a tile,
    TRSM m²·mb, POTRF m³/3, carry 3·m³, flash 4·hd a kept (query, key) pair
    and head; the kernels that PERF.md bounds by bytes count the products
    they make: cov_tiles 2·D an entry (the distance), LRGEMM 2·m·mb a tile,
    ``tile_gemv`` 2·m·n a tile, ``tile_trsv`` m² a tile.
    """
    nbytes = _nbytes(*args, out)
    if name == "potrf":
        g, m = args[0].shape[0], args[0].shape[-1]
        ops = g * m ** 3 / 3.0
    elif name == "trsm":
        l, b = args
        ops = b.shape[0] * l.shape[-1] ** 2 * b.shape[-2]
    elif name == "trail":
        _, a, b = args
        ops = 2.0 * a.shape[0] * a.shape[1] * b.shape[1] * a.shape[2]
    elif name == "carry_update":
        ops = 3.0 * args[0].shape[0] * args[3].shape[-1] ** 3
    elif name == "cov_tiles":
        xa, xb = args[:2]
        ops = 2.0 * xa.shape[0] * xa.shape[1] * xb.shape[1] * xa.shape[2]
    elif name == "lrgemm":
        kflat, _, a_idx, _ = args
        ops = 2.0 * a_idx.shape[0] * kflat.shape[1] * kflat.shape[2]
    elif name == "tile_gemv":
        a = args[0]
        ops = 2.0 * a.numel()
    elif name == "tile_trsv":
        ops = float(args[0].numel())
    elif name == "flash_attention":
        q, k = args[:2]
        b, s, h, hd = q.shape
        ops = 4.0 * hd * b * h * attention_pairs(s, k.shape[1], kw["causal"], kw["window"])
    else:
        raise KeyError(name)
    return float(ops), nbytes


class KernelCount:
    """What :func:`counting` yields: per kernel, its calls, the launches they make on the card (the same count on
    every route: no route but the card's launches anything), their operations and their bytes."""

    def __init__(self, on_output: Optional[Callable[[torch.Tensor], None]] = None):
        self.calls: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.ops: Dict[str, float] = {}
        self.bytes: Dict[str, float] = {}
        self._on_output = on_output

    def add(self, name: str, args: tuple, out: torch.Tensor, launches: int = 1, **kw) -> None:
        ops, nbytes = kernel_cost(name, args, out, **kw)
        self.calls[name] = self.calls.get(name, 0) + 1
        self.launches[name] = self.launches.get(name, 0) + launches
        self.ops[name] = self.ops.get(name, 0.0) + ops
        self.bytes[name] = self.bytes.get(name, 0.0) + nbytes
        if self._on_output is not None:
            self._on_output(out)

    @property
    def total_ops(self) -> float:
        return sum(self.ops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


_COUNT: Optional[KernelCount] = None


@contextlib.contextmanager
def counting(on_output: Optional[Callable[[torch.Tensor], None]] = None):
    """A :class:`KernelCount` that every op call inside the block adds to; ``on_output(out)`` sees each result."""
    global _COUNT
    before, _COUNT = _COUNT, KernelCount(on_output)
    try:
        yield _COUNT
    finally:
        _COUNT = before


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


def _dispatch(name: str, on: torch.Tensor, args: tuple, *, kernel, plain, shape, ref=None, plain_via_ref=False,
              cost_args=None, launches=1, **cost_kw) -> torch.Tensor:
    """Op ``name`` on ``args`` by the route ``on``'s device picks.

    cuda: ``kernel``, through :class:`_RefGrad` under grad, and the op's
    ``launches`` bumped (``cov_tiles``' wrapper bumps its own, a launch);
    cpu: ``plain``, through :class:`_RefGrad` only where ``plain_via_ref``
    (a plain version that autograd cannot go through, or a caller's ``ref``);
    meta: ``shape``, an empty result of the kernel's output shape and type.
    Inside :func:`counting` the route runs with the dispatch modes set
    aside, and the call adds ``launches`` and the cost of ``cost_args``
    (default ``args``) to the count.
    """
    if _on_meta(on):
        fn, via_ref = shape, True
    elif not _on_cuda(on, name):
        fn, via_ref = plain, plain_via_ref
    else:
        fn, via_ref = kernel, True

    def route():
        return _run(name, fn, *args, ref=ref) if via_ref else fn(*args)

    if _COUNT is None:
        out = route()
    else:
        with _disable_current_modes():
            out = route()
            _COUNT.add(name, args if cost_args is None else cost_args, out, launches, **cost_kw)
    if fn is kernel and name != "cov_tiles":
        KERNEL_OPS[name].launches += 1
    return out


def potrf(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (G, m, m) stack."""
    return _dispatch("potrf", a, (a,), kernel=_potrf.potrf_cuda, plain=_potrf.potrf_plain, shape=torch.empty_like,
                     plain_via_ref=True)


def trsm(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X with X L^T = B for (G, m, m) stacks of L and B."""
    return _dispatch("trsm", b, (l, b), kernel=_trsm.trsm_cuda, plain=_trsm.trsm_plain,
                     shape=lambda l, b: torch.empty_like(b), plain_via_ref=True)


def trail(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, update_dtype=None) -> torch.Tensor:
    """C - A B^T for (G, m, m) stacks; ``update_dtype`` casts A and B only."""
    if update_dtype is not None:
        a, b = a.to(update_dtype), b.to(update_dtype)
    return _dispatch("trail", c, (c, a, b), kernel=_trail.trail_cuda, plain=_trail.trail_plain,
                     shape=lambda c, a, b: torch.empty_like(c))


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
    # every tensor leaf of the params tree, at any depth, is an operand of _RefGrad; the rest stay bound
    split = km.TensorLeaves(params)

    def bound(fn, **extra):
        def tiles(xa, xb, *values):
            p = split.rebuild(values)
            return fn(xa, xb, row0, col0, n_valid_r, n_valid_c, p, symmetric=symmetric, kernel=kernel, **extra)
        return tiles

    def shape(xa, xb, *values):
        return _empty((xa.shape[0], xa.shape[1], xb.shape[1]), xa.dtype, xa)

    # one launch per distance of a mixed composite, bumped where it happens, in cov_assembly; the counting scope
    # reads the same number off the kernel tree (the descriptor's, where there is one)
    if _COUNT is None:
        launches = 0
    else:
        launches = len(table.launches) if table is not None else km.cov_launch_count(kernel, params)
    extra = {} if table is None else {"table": table}
    return _dispatch("cov_tiles", xa, (xa, xb, *split.values()), kernel=bound(_cov.cov_tiles_cuda, **extra),
                     plain=bound(_cov.cov_tiles_plain), shape=shape, ref=bound(_cov.cov_tiles_plain),
                     cost_args=(xa, xb), launches=launches)


def carry_update(w: torch.Tensor, l: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(W - L Y) C^{-T} for (G, m, m) stacks (the fused UCARRY step)."""
    if w.device.type != "cpu":
        _no_backward("carry_update", w, l, y, c)
    return _dispatch("carry_update", w, (w, l, y, c), kernel=_carry.carry_update_cuda,
                     plain=_carry.carry_update_plain, shape=lambda w, l, y, c: torch.empty_like(w))


def lrgemm(kflat: torch.Tensor, v: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """(G, m) tile matvecs ``kflat[a[g]] @ v[b[g]]`` of (T, m, mb) tiles and (M, mb) chunks."""
    def shape(kflat, v, a_idx, b_idx):
        return _empty((a_idx.shape[0], kflat.shape[1]), kflat.dtype, kflat)

    return _dispatch("lrgemm", kflat, (kflat, v, a_idx, b_idx), kernel=_lrgemm.lrgemm_cuda,
                     plain=_lrgemm.lrgemm_plain, shape=shape)


def tile_gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Z, G, m): ``sum_q a[z, g, q] @ x[z, g, q]`` of (Z, G, Q, m, n) tiles and (Z, G, Q, n) vectors."""
    def shape(a, x):
        return _empty(a.shape[:2] + a.shape[3:4], torch.result_type(a, x), a)

    return _dispatch("tile_gemv", a, (a, x), kernel=_gemv.tile_gemv_cuda, plain=_gemv.tile_gemv_plain, shape=shape,
                     ref=_gemv.tile_gemv_plain)


def tile_trsv(l: torch.Tensor, r: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """(Z, G, m): ``l^-1 r`` (or ``l^-T r``) of (Z, G, m, m) lower tiles and (Z, G, m) vectors."""
    def ref(l, r):
        return _gemv.tile_trsv_plain(l, r, transpose)

    return _dispatch("tile_trsv", l, (l, r), kernel=lambda l, r: _gemv.tile_trsv_cuda(l, r, transpose), plain=ref,
                     shape=lambda l, r: torch.empty_like(r), ref=ref)


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

    def shape(q, k, v, causal, softcap, window):
        _flash._check_args(q, k, v, causal, window)
        return torch.empty_like(q)

    plain = kernel_of(_flash.flash_attention_plain)
    return _dispatch("flash_attention", q, (q, k, v), kernel=kernel_of(_flash.flash_attention_cuda), plain=plain,
                     shape=kernel_of(shape), ref=ref or plain, plain_via_ref=True, causal=causal, window=window)


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
