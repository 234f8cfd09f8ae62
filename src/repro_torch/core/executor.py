"""Schedule-driven level-batched executor: the stream pool of the paper.

A :class:`repro_torch.core.scheduler.Schedule` compiles into a static plan:

  for each level (ASAP antichain, or <= n_streams wavefront wave):
      group the level's tasks by op        # POTRF / TRSM / TRAIL / ...
      for each round-robin chunk of <= n_streams tasks:
          gather operand tiles (precomputed index arrays)
          ONE batched launch over the (G, m, m) stack
          scatter the results back into the buffer

Plans (gather/scatter index arrays per level) are pure functions of the
tile geometry and ``n_streams`` and are lru-cached.  The tile ops come from
:mod:`repro_torch.kernels.ops`: on CUDA tensors they launch the port's
hand-written kernels, on CPU tensors their plain versions.  The solve and
head ops (TRSV, GEMV, XGEMV, VINIT, VTRSV, VGEMV, GRAM) are plain torch
(``solve_triangular``, ``einsum``), as the JAX package leaves them to XLA.

The streaming updates run two more plan families over the same store:
``run_append`` (one appended tile-row, UASM/UASMD/UTRSM/UGEMM/USYRK/UPOTRF)
and ``run_rank_update`` (the blocked cholupdate sweep, UPREP/UPROW/UCARRY,
whose UCARRY step is the port's ``carry_update`` kernel).  The low-rank
tier's n-side contraction is one more plan, ``lowrank_plan``: the LRGEMM
family as one ``lrgemm`` kernel launch (``run_lowrank_contraction``).

The buffers of a run are updated in place (``index_copy_`` /
``index_add_``) where the JAX executor used functional ``.at[].set`` /
``.at[].add``; every entry point works on its own copies of its inputs.

**Problem batching.**  Every buffer may carry a leading problem axis B: B
independent GPs of one tile geometry run through the same lru-cached Plan
(a plan depends on the tile counts, never on B).  Gathers and scatters move
from axis 0 to axis 1, and each batched launch covers B x G tiles: the
default dispatch, ``batch_dispatch="flat"``, folds B into the kernel's own
batch axis (one launch of B * G tiles, problem-major), ``"vmap"`` keeps the
reference's second mode as one launch per problem (a ctypes kernel cannot
sit under ``torch.vmap``).  Hyperparameters may be shared or per-problem
((B,) leaves, read by the cov_tiles kernel from a device table built once a
run), and the validity frontiers ``n_valid``/``nt_valid`` may be (B,) int32
device tensors (a ragged fleet's bucket), expanded per tile on the device
and never read back inside a program.  The mesh and the telemetry hooks of
the JAX executor come with later slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import kernels_math as km
from repro_torch.core import scheduler as sch
from repro_torch.core import tiling
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Compiled plans: per level, per op, per stream-chunk gather/scatter indices.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Batch:
    """One batched launch: gather operands, compute, scatter ``out``.

    Index semantics by op (numpy int64 arrays, length = batch size):
      POTRF: a = diagonal slots;                       out = a
      TRSM:  a = L_JJ slots, b = panel slots;          out = b
      SYRK:  a = target (i,i) slots, b = panel slots;  out = a
      GEMM:  a = target slots, b/c = panel slots;      out = a
      TRSV:  a = diagonal slots;                       out = rhs tile-rows
      GEMV:  a = L tile slots, b = source tile-rows;   out = dest tile-rows
    """

    op: str
    tasks: Tuple[sch.Task, ...]
    out: np.ndarray
    a: np.ndarray
    b: Optional[np.ndarray] = None
    c: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return len(self.tasks)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """A schedule compiled to batched gather/compute/scatter launches."""

    kind: str
    m_tiles: int
    n_streams: Optional[int]
    levels: Tuple[Tuple[Batch, ...], ...]

    @property
    def n_batches(self) -> int:
        return sum(len(l) for l in self.levels)

    def level_task_counts(self) -> List[int]:
        """Tasks per level — must match ``len(level)`` of the source Schedule."""
        return [sum(b.size for b in level) for level in self.levels]

    def flat_tasks(self) -> List[sch.Task]:
        """Tasks in issue order (level-major, batch order within a level)."""
        return [t for level in self.levels for b in level for t in b.tasks]

    def launches_by_op(self) -> Dict[str, int]:
        """Batched launches per op (dispatch group) in one run of the plan."""
        counts: Dict[str, int] = {}
        for level in self.levels:
            for bt in level:
                counts[bt.op] = counts.get(bt.op, 0) + 1
        return counts


def _arr(xs: Sequence[int]) -> np.ndarray:
    return np.asarray(xs, np.int64)


_plan_stats_cache: Dict[int, dict] = {}


def plan_wave_stats(plan: Plan) -> dict:
    """Static per-Plan wave digest: waves, launches, tasks by op family,
    bulk-op ride-alongs, and mean stream-pool occupancy (pool tasks per
    pool-bearing wave over ``n_streams``; 1.0 for an unbounded pool).
    Memoized per Plan (plans live in the lru caches), so recording a
    dispatch costs a dict hit."""
    st = _plan_stats_cache.get(id(plan))
    if st is not None and st["_plan"] is plan:
        return st["stats"]
    by_op: dict = {}
    bulk_tasks = pool_tasks = pool_waves = 0
    for level in plan.levels:
        level_pool = 0
        for bt in level:
            by_op[bt.op] = by_op.get(bt.op, 0) + bt.size
            if bt.op in sch.BULK_OPS:
                bulk_tasks += bt.size
            else:
                level_pool += bt.size
        if level_pool:
            pool_waves += 1
            pool_tasks += level_pool
    if plan.n_streams and pool_waves:
        occupancy = pool_tasks / (pool_waves * plan.n_streams)
    else:
        occupancy = 1.0 if pool_tasks else 0.0
    stats = {
        "plan": plan.kind,
        "waves": len(plan.levels),
        "launches": plan.n_batches,
        "tasks": bulk_tasks + pool_tasks,
        "bulk_tasks": bulk_tasks,
        "pool_tasks": pool_tasks,
        "n_streams": plan.n_streams,
        "occupancy": occupancy,
        "by_op": by_op,
    }
    _plan_stats_cache[id(plan)] = {"_plan": plan, "stats": stats}
    return stats


def record_dispatch(kind: str, plan: Plan, *, device: torch.device, batched: bool) -> None:
    """Count and log one dispatch of ``plan`` (callers guard with ``obs.enabled()``).

    ``executor.dispatch.<kind>``, ``executor.launches`` and
    ``executor.tasks.<op>`` counters and one ``executor.wave`` event, all
    from the plan's static digest: nothing reads a device value.
    """
    st = plan_wave_stats(plan)
    obs.inc(f"executor.dispatch.{kind}")
    obs.inc("executor.launches", st["launches"])
    for op, cnt in st["by_op"].items():
        obs.inc(f"executor.tasks.{op}", cnt)
    obs.event("executor.wave", dispatch=kind, backend=device.type, batched=bool(batched), **st)


def _cholesky_batch(op: str, tasks: Sequence[sch.Task], m: int) -> Batch:
    slot = tiling.packed_index
    tasks = tuple(tasks)
    if op == sch.POTRF:
        d = _arr([slot(j, j, m) for _, _, j, _ in tasks])
        return Batch(op, tasks, out=d, a=d)
    if op == sch.TRSM:
        diag = _arr([slot(j, j, m) for _, _, j, _ in tasks])
        tgt = _arr([slot(i, j, m) for _, i, j, _ in tasks])
        return Batch(op, tasks, out=tgt, a=diag, b=tgt)
    if op == sch.SYRK:
        tgt = _arr([slot(i, i, m) for _, i, _, _ in tasks])
        panel = _arr([slot(i, j, m) for _, i, j, _ in tasks])
        return Batch(op, tasks, out=tgt, a=tgt, b=panel)
    if op == sch.GEMM:
        tgt = _arr([slot(i, k, m) for _, i, _, k in tasks])
        pa = _arr([slot(i, j, m) for _, i, j, _ in tasks])
        pb = _arr([slot(k, j, m) for _, _, j, k in tasks])
        return Batch(op, tasks, out=tgt, a=tgt, b=pa, c=pb)
    raise ValueError(op)


def _solve_batch(op: str, tasks: Sequence[sch.Task], m: int, lower: bool) -> Batch:
    slot = tiling.packed_index
    tasks = tuple(tasks)
    if op == sch.TRSV:
        rows = _arr([i for _, i, _, _ in tasks])
        diag = _arr([slot(i, i, m) for _, i, _, _ in tasks])
        return Batch(op, tasks, out=rows, a=diag)
    if op == sch.GEMV:
        dst = _arr([i for _, i, _, _ in tasks])
        src = _arr([j for _, _, j, _ in tasks])
        tiles = _arr(
            [slot(i, j, m) if lower else slot(j, i, m) for _, i, j, _ in tasks]
        )
        return Batch(op, tasks, out=dst, a=tiles, b=src)
    raise ValueError(op)


def _compile(schedule: sch.Schedule, n_streams: Optional[int], batch_fn) -> Plan:
    levels = []
    for level in schedule.levels:
        batches = []
        for op, tasks in sch.split_by_op(level).items():
            for chunk in sch.chunk_tasks(tasks, n_streams):
                batches.append(batch_fn(op, chunk, schedule.m_tiles))
        levels.append(tuple(batches))
    return Plan(schedule.kind, schedule.m_tiles, n_streams, tuple(levels))


@functools.lru_cache(maxsize=None)
def cholesky_plan(m_tiles: int, n_streams: Optional[int] = None) -> Plan:
    """``None``: whole-ASAP-level batches.  Finite: the wavefront schedule."""
    if n_streams is None:
        schedule = sch.build_schedule(m_tiles)
    else:
        schedule = sch.build_wavefront_schedule(m_tiles, n_streams, kind="cholesky")
    return _compile(schedule, n_streams, _cholesky_batch)


@functools.lru_cache(maxsize=None)
def solve_plan(
    m_tiles: int, *, lower: bool = True, n_streams: Optional[int] = None
) -> Plan:
    kind = "forward" if lower else "backward"
    if n_streams is None:
        schedule = sch.build_solve_schedule(m_tiles, lower=lower)
    else:
        schedule = sch.build_wavefront_schedule(m_tiles, n_streams, kind=kind)
    return _compile(
        schedule, n_streams, functools.partial(_solve_batch, lower=lower)
    )


# ---------------------------------------------------------------------------
# Execution.
# ---------------------------------------------------------------------------

# Device copies of a plan's index arrays, keyed by (id(array), device).  Plans
# are lru-cached for the life of the process, so the ids stay valid and each
# index array crosses to the device once.
_device_index: Dict[Tuple[int, str], Tuple[np.ndarray, torch.Tensor]] = {}


def _idx(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (id(arr), str(device))
    hit = _device_index.get(key)
    if hit is None or hit[0] is not arr:
        hit = (arr, torch.from_numpy(arr).to(device))
        _device_index[key] = hit
    return hit[1]


def m_tiles_of_packed(packed: torch.Tensor) -> int:
    """Tile count M of a packed (T, m, m) store, validating T = M(M+1)/2."""
    t = packed.shape[-3]
    m_tiles = int((np.sqrt(8 * t + 1) - 1) // 2)
    if tiling.num_packed_tiles(m_tiles) != t:
        raise ValueError(f"{t} is not a triangular number of tiles")
    return m_tiles


def _env_ops(device: torch.device, batched: bool = False):
    """(take, put, add) accessors with plan index arrays.

    Unbatched buffers gather and scatter on axis 0; batched buffers carry
    the problem axis B first and gather and scatter on axis 1, with the same
    index arrays and the same Plan.
    """
    axis = 1 if batched else 0

    def take(buf, idx):
        return buf.index_select(axis, _idx(idx, device))

    def put(buf, idx, val):
        buf.index_copy_(axis, _idx(idx, device), val)

    def add(buf, idx, val):
        buf.index_add_(axis, _idx(idx, device), val)

    return take, put, add


def _tile_dispatch(fn, batched: bool, mode: str = "flat"):
    """Lift a stack op ``fn((G, ...) operands)`` to (B, G, ...) operands of B problems.

    ``"flat"`` reshapes every operand to (B * G, ...) for ONE launch and the
    results back to (B, G, ...); ``"vmap"`` keeps the reference's second
    mode as one launch per problem, stacked (a ctypes kernel cannot sit
    under ``torch.vmap``).  Ops with several results (a tuple) are lifted
    result by result.  Unbatched, ``fn`` is returned as it is.
    """
    if mode not in ("flat", "vmap"):
        raise ValueError(f"batch_dispatch must be 'flat' or 'vmap', got {mode!r}")
    if not batched:
        return fn

    def unflat(out, b, g):
        if isinstance(out, tuple):
            return tuple(o.reshape((b, g) + o.shape[1:]) for o in out)
        return out.reshape((b, g) + out.shape[1:])

    def flat(*arrays):
        b, g = arrays[0].shape[:2]
        return unflat(fn(*[a.reshape((b * g,) + a.shape[2:]) for a in arrays]), b, g)

    def per_problem(*arrays):
        outs = [fn(*[a[i] for a in arrays]) for i in range(arrays[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)

    return flat if mode == "flat" else per_problem


def run_cholesky(
    packed: torch.Tensor,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    batch_dispatch: str = "flat",
    device="cuda",
) -> torch.Tensor:
    """Factor a packed (T, m, m) store K -> L by walking the level schedule.

    Each Batch is one gather, one batched kernel launch and one scatter;
    tasks inside a level are independent, so batches may mix columns.
    ``packed`` may be (B, T, m, m): B problems through the same Plan, every
    launch B times wider.  Returns a new tensor; ``packed`` itself is not
    modified.
    """
    dev = resolve_device(device)
    packed = torch.as_tensor(packed, device=dev).clone()
    batched = packed.ndim == 4
    take, put, _ = _env_ops(dev, batched)
    plan = cholesky_plan(m_tiles_of_packed(packed), n_streams)
    potrf = _tile_dispatch(ops.potrf, batched, batch_dispatch)
    trsm = _tile_dispatch(ops.trsm, batched, batch_dispatch)
    trail = _tile_dispatch(lambda c, a, b: ops.trail(c, a, b, update_dtype), batched, batch_dispatch)
    for level in plan.levels:
        for bt in level:
            if bt.op == sch.POTRF:
                put(packed, bt.out, potrf(take(packed, bt.a)))
            elif bt.op == sch.TRSM:
                put(packed, bt.out, trsm(take(packed, bt.a), take(packed, bt.b)))
            elif bt.op == sch.SYRK:
                pb = take(packed, bt.b)
                put(packed, bt.out, trail(take(packed, bt.a), pb, pb))
            else:
                put(packed, bt.out, trail(take(packed, bt.a), take(packed, bt.b), take(packed, bt.c)))
    return packed


def matrix_product(eq: str, a: torch.Tensor, b: torch.Tensor, batched: bool) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` for the matrix right-hand sides of the uncertainty tail.

    ``eq`` names one problem's operands.  ``batched`` operands carry a
    leading problem axis, and each problem takes the float32 product that a
    problem alone takes; the B results are stacked.  One einsum over the B
    problems runs cuBLAS's strided-batched SGEMM, which lost accuracy
    against the same products taken one problem at a time and failed the
    fleet's variance rule (phase ``fleet.batch`` on the card).
    """
    if not batched:
        return torch.einsum(eq, a, b)
    return torch.stack([torch.einsum(eq, ai, bi) for ai, bi in zip(a, b)])


def _trsv_batch(lii: torch.Tensor, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Batched diagonal-tile solve L x = rhs (or L^T x = rhs).

    lii (..., G, m, m); x (..., G, m) vector chunks or (..., G, Q, m, mq)
    matrix tile-rows, ``...`` the optional problem axis.
    """
    if transpose:
        lii, upper = lii.transpose(-1, -2), True
    else:
        upper = False
    if x.ndim == lii.ndim - 1:  # vector rhs chunks
        return torch.linalg.solve_triangular(lii, x[..., None], upper=upper)[..., 0]
    return torch.linalg.solve_triangular(lii.unsqueeze(-3), x, upper=upper)


# ---------------------------------------------------------------------------
# Whole-pipeline program execution.
#
# The named buffer environment:
#
#   "packed"  (T, m, m)       covariance tiles -> Cholesky factor (in place)
#   "y"       (M, m)          y chunks -> beta (forward substitution)
#   "alpha"   (M, m)          beta -> alpha (backward substitution)
#   "cross"   (Q*M, m, m)     cross-covariance tile grid K_{X̂,X} (flat)
#   "mean"    (Q, m)          predictive-mean chunks
#   "v"       (M, Q, m, m)    uncertainty workspace V = L^{-1} K_{X,X̂}
#   "prior"   (Q*Q, m, m)     prior test tiles -> posterior covariance tiles
#
# plus the read-only feature blocks xc (M, m, D) / xtc (Q, m, D).  SYRK and
# GEMM tasks of a level are dispatched as one fused trailing-update launch
# (TRAIL).
# ---------------------------------------------------------------------------

TRAIL = sch.TRAIL_GROUP  # fused SYRK+GEMM dispatch group (program plans only)


def _program_batch(
    op: str, tasks: Sequence[sch.Task], m: int, q_tiles: int
) -> Batch:
    """Gather/scatter indices of one program batch (buffer roles fixed by op)."""
    slot = tiling.packed_index
    tasks = tuple(tasks)
    if op in (sch.POTRF, sch.TRSM):
        return _cholesky_batch(op, tasks, m)
    if op == TRAIL:
        tgt, pa, pb = [], [], []
        for t in tasks:
            _, i, j, k = t
            if t[0] == sch.SYRK:
                tgt.append(slot(i, i, m))
                pa.append(slot(i, j, m))
                pb.append(slot(i, j, m))
            else:
                tgt.append(slot(i, k, m))
                pa.append(slot(i, j, m))
                pb.append(slot(k, j, m))
        return Batch(op, tasks, out=_arr(tgt), a=_arr(tgt), b=_arr(pa), c=_arr(pb))
    if op in (sch.TRSV, sch.GEMV):
        return _solve_batch(op, tasks, m, lower=True)
    if op in (sch.TRSV_B, sch.GEMV_B):
        base = _solve_batch(
            sch.TRSV if op == sch.TRSV_B else sch.GEMV, tasks, m, lower=False
        )
        return dataclasses.replace(base, op=op, tasks=tasks)
    if op == sch.ASSEMBLE:
        rows = _arr([i for _, i, _, _ in tasks])
        cols = _arr([j for _, _, j, _ in tasks])
        slots = _arr([slot(i, j, m) for _, i, j, _ in tasks])
        return Batch(op, tasks, out=slots, a=rows, b=cols)
    if op == sch.CROSS:
        p = _arr([i for _, i, _, _ in tasks])
        q = _arr([j for _, _, j, _ in tasks])
        return Batch(op, tasks, out=_arr([i * m + j for _, i, j, _ in tasks]), a=p, b=q)
    if op == sch.PRIOR:
        p = _arr([i for _, i, _, _ in tasks])
        q = _arr([j for _, _, j, _ in tasks])
        return Batch(
            op, tasks, out=_arr([i * q_tiles + j for _, i, j, _ in tasks]), a=p, b=q
        )
    if op in (sch.XGEMV, sch.VINIT):
        rows = _arr([i for _, i, _, _ in tasks])
        return Batch(op, tasks, out=rows, a=rows)
    if op in (sch.VTRSV, sch.VGEMV):
        base = _solve_batch(
            sch.TRSV if op == sch.VTRSV else sch.GEMV, tasks, m, lower=True
        )
        return dataclasses.replace(base, op=op, tasks=tasks)
    if op == sch.GRAM:
        return Batch(op, tasks, out=_arr([]), a=_arr([]))
    raise ValueError(op)


@functools.lru_cache(maxsize=None)
def program_plan(
    m_tiles: int,
    q_tiles: int,
    uncertainty: bool = False,
    n_streams: Optional[int] = None,
) -> Plan:
    """Compile the fused prediction program into batched launches.

    ``None``: ASAP levels of the whole-pipeline DAG.  Finite: the
    cross-stage wavefront schedule.  BULK ops are never chunked.
    """
    if n_streams is None:
        schedule = sch.build_program_schedule(
            m_tiles, q_tiles, uncertainty=uncertainty
        )
    else:
        schedule = sch.build_wavefront_schedule(
            m_tiles,
            n_streams,
            kind="program",
            q_tiles=q_tiles,
            uncertainty=uncertainty,
        )
    levels = []
    for level in schedule.levels:
        groups: dict = {}
        for t in level:
            groups.setdefault(sch.dispatch_group(t[0]), []).append(t)
        batches = []
        for gop, tasks in groups.items():
            width = None if gop in sch.BULK_OPS else n_streams
            for chunk in sch.chunk_tasks(tasks, width):
                batches.append(_program_batch(gop, chunk, m_tiles, q_tiles))
        levels.append(tuple(batches))
    return Plan("program", m_tiles, n_streams, tuple(levels))


def staged_launch_count(
    m_tiles: int, *, uncertainty: bool = False, n_streams: Optional[int] = None
) -> int:
    """Batched launches the *staged* pipeline issues end-to-end.

    One covariance assembly + the factorization plan + both vector-solve
    plans + cross assembly + mean matvec; with uncertainty also the prior
    assembly, the transpose pack, the matrix forward-solve plan, the gram
    and the prior - W subtraction.
    """
    n = 1 + cholesky_plan(m_tiles, n_streams).n_batches
    n += solve_plan(m_tiles, lower=True, n_streams=n_streams).n_batches
    n += solve_plan(m_tiles, lower=False, n_streams=n_streams).n_batches
    n += 1 + 1  # cross assembly, mean matvec
    if uncertainty:
        n += 1 + 1  # prior assembly, transpose pack
        n += solve_plan(m_tiles, lower=True, n_streams=n_streams).n_batches
        n += 1 + 1  # gram, prior - W subtraction
    return n


def _per_tile(v, b: int, g: int):
    """A frontier for the B * G tiles of a flat launch: a scalar stays, (B,) goes per tile."""
    if isinstance(v, torch.Tensor) and v.ndim > 0:
        return v.reshape(b, 1).expand(b, g).reshape(b * g)
    return v


def _pick(v, i: int):
    """Problem ``i``'s frontier: a scalar stays, (B,) gives its entry."""
    return v[i] if isinstance(v, torch.Tensor) and v.ndim > 0 else v


def _frontier(v, device):
    """A frontier as given: an int, or a tensor moved to ``device`` as int32 (never read on the host)."""
    return v.to(device=device, dtype=torch.int32) if isinstance(v, torch.Tensor) else v


def _cov_batch_fn(params, nvr, nvc, symmetric: bool, kernel, table=None):
    """Batched covariance-tile assembly (G,m,D) x (G,m,D) -> (G,m,m)."""

    def fn(xa, xb, row0, col0):
        return ops.cov_tiles(
            xa, xb, row0, col0, nvr, nvc, params, symmetric=symmetric, kernel=kernel, table=table
        )

    return fn


def _cov_batch_fn_batched(params, nvr, nvc, symmetric: bool, kernel, table=None, mode: str = "flat"):
    """Problem-batched assembly: (B,G,m,D) x (B,G,m,D) -> (B,G,m,m).

    Shared params, per-problem params ((B,) leaves) and ragged frontiers
    ((B,) ``nvr``/``nvc``) all go to ONE cov_tiles launch of B * G tiles
    with ``mode="flat"``: the kernel reads each problem's row of the
    descriptor table (``table``, built once a run) and each tile's frontier.
    The reference routes per-problem params to its plain tile, since its
    Pallas kernel bakes hyperparameters in as constants.  ``mode="vmap"``
    launches once per problem.  ``row0``/``col0`` are the (G,) offsets of
    one problem's tiles, or ints.
    """

    def flat(xa, xb, row0, col0):
        b, g = xa.shape[:2]
        tiles = ops.cov_tiles(
            xa.reshape((b * g,) + xa.shape[2:]), xb.reshape((b * g,) + xb.shape[2:]),
            row0.repeat(b) if isinstance(row0, torch.Tensor) else row0,
            col0.repeat(b) if isinstance(col0, torch.Tensor) else col0,
            _per_tile(nvr, b, g), _per_tile(nvc, b, g), params,
            symmetric=symmetric, kernel=kernel, table=table,
        )
        return tiles.reshape((b, g) + tiles.shape[1:])

    def per_problem(xa, xb, row0, col0):
        return torch.stack([
            ops.cov_tiles(
                xa[i], xb[i], row0, col0, _pick(nvr, i), _pick(nvc, i), km.gather_params(params, i, kernel),
                symmetric=symmetric, kernel=kernel, table=None if table is None else table.select(i),
            )
            for i in range(xa.shape[0])
        ])

    if mode not in ("flat", "vmap"):
        raise ValueError(f"batch_dispatch must be 'flat' or 'vmap', got {mode!r}")
    return flat if mode == "flat" else per_problem


def run_program(
    xc: torch.Tensor,
    yc: torch.Tensor,
    xtc: torch.Tensor,
    params,
    n_valid,
    nt_valid,
    *,
    uncertainty: bool = False,
    n_streams: Optional[int] = None,
    update_dtype=None,
    batch_dispatch: str = "flat",
    kernel=None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Execute the fused prediction pipeline as one multi-stage program.

    xc (M, m, D) / yc (M, m) / xtc (Q, m, D) are the padded feature and
    target blocks (moved to ``device``); ``n_valid`` / ``nt_valid`` the
    unpadded row counts.  Returns the final buffer environment (see the
    section comment above): ``env["mean"]`` holds the predictive-mean
    chunks, ``env["prior"]`` the posterior-covariance tiles (uncertainty
    only), and ``env["packed"]`` / ``env["alpha"]`` / ``env["y"]`` the
    factor, weights and forward-solve chunks a PosteriorState caches.

    **Problem batching:** with xc (B, M, m, D) / yc (B, M, m) /
    xtc (B, Q, m, D) every buffer gains the leading B axis and the same
    Plan drives all B problems (the same launch count, every launch B times
    wider).  ``params`` leaves may be shared or (B,); ``n_valid`` /
    ``nt_valid`` may be (B,) int tensors of per-problem row counts (a
    ragged bucket): only the masked assembly reads them, on the device.
    """
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    xc, xtc = torch.as_tensor(xc, device=dev), torch.as_tensor(xtc, device=dev)
    batched = xc.ndim == 4
    m_tiles, m = xc.shape[-3], xc.shape[-2]
    q_tiles = xtc.shape[-3]
    plan = program_plan(m_tiles, q_tiles, uncertainty, n_streams)
    if obs.enabled():
        record_dispatch("run_program", plan, device=dev, batched=batched)
    dtype = xc.dtype
    lead = (xc.shape[0],) if batched else ()
    take, put, add = _env_ops(dev, batched)
    z = "z" if batched else ""  # einsum prefix of the problem axis
    n_valid, nt_valid = _frontier(n_valid, dev), _frontier(nt_valid, dev)

    table = ops.cov_descriptor(kernel, params, xc.shape[-1], dtype, dev)
    if batched:
        cov_fn = functools.partial(_cov_batch_fn_batched, table=table, mode=batch_dispatch)
    else:
        cov_fn = functools.partial(_cov_batch_fn, table=table)
    asm = cov_fn(params, n_valid, n_valid, True, kernel)
    crossf = cov_fn(params, nt_valid, n_valid, False, kernel)
    priorf = cov_fn(params, nt_valid, nt_valid, False, kernel)
    potrf = _tile_dispatch(ops.potrf, batched, batch_dispatch)
    trsm = _tile_dispatch(ops.trsm, batched, batch_dispatch)
    trail = _tile_dispatch(lambda c, a, b: ops.trail(c, a, b, update_dtype), batched, batch_dispatch)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    env = {
        "packed": zeros(tiling.num_packed_tiles(m_tiles), m, m),
        "y": torch.as_tensor(yc, device=dev).to(dtype, copy=True),
        "alpha": zeros(m_tiles, m),
        "cross": zeros(q_tiles * m_tiles, m, m),
        "mean": zeros(q_tiles, m),
    }
    if uncertainty:
        env["v"] = zeros(m_tiles, q_tiles, m, m)
        env["prior"] = zeros(q_tiles * q_tiles, m, m)

    def off(idx):  # tile index -> global row/col offset
        return _idx(idx, dev) * m

    def cross_grid():  # cross buffer viewed as the (..., Q, M, m, m) tile grid
        return env["cross"].view(lead + (q_tiles, m_tiles, m, m))

    packed = env["packed"]
    for level in plan.levels:
        for bt in level:
            op = bt.op
            if op == sch.ASSEMBLE:
                put(packed, bt.out, asm(take(xc, bt.a), take(xc, bt.b), off(bt.a), off(bt.b)))
            elif op == sch.CROSS:
                tiles = crossf(take(xtc, bt.a), take(xc, bt.b), off(bt.a), off(bt.b))
                put(env["cross"], bt.out, tiles)
            elif op == sch.PRIOR:
                tiles = priorf(take(xtc, bt.a), take(xtc, bt.b), off(bt.a), off(bt.b))
                put(env["prior"], bt.out, tiles)
            elif op == sch.POTRF:
                put(packed, bt.out, potrf(take(packed, bt.a)))
            elif op == sch.TRSM:
                put(packed, bt.out, trsm(take(packed, bt.a), take(packed, bt.b)))
            elif op == TRAIL:
                put(packed, bt.out, trail(take(packed, bt.a), take(packed, bt.b), take(packed, bt.c)))
            elif op == sch.TRSV:
                sol = _trsv_batch(take(packed, bt.a), take(env["y"], bt.out), False)
                put(env["y"], bt.out, sol)
                # publish the solved row into the backward pass's buffer
                put(env["alpha"], bt.out, sol)
            elif op == sch.GEMV:
                upd = torch.einsum(f"{z}gab,{z}gb->{z}ga", take(packed, bt.a), take(env["y"], bt.b))
                add(env["y"], bt.out, -upd)
            elif op == sch.TRSV_B:
                sol = _trsv_batch(take(packed, bt.a), take(env["alpha"], bt.out), True)
                put(env["alpha"], bt.out, sol)
            elif op == sch.GEMV_B:
                upd = torch.einsum(f"{z}gba,{z}gb->{z}ga", take(packed, bt.a), take(env["alpha"], bt.b))
                add(env["alpha"], bt.out, -upd)
            elif op == sch.XGEMV:
                rows = take(cross_grid(), bt.out)
                put(env["mean"], bt.out, torch.einsum(f"{z}gqab,{z}qb->{z}ga", rows, env["alpha"]))
            elif op == sch.VINIT:
                if batched:
                    cols = cross_grid()[:, :, _idx(bt.out, dev)]          # (B, Q, G, m, m)
                    put(env["v"], bt.out, cols.permute(0, 2, 1, 4, 3))     # (B, G, Q, m, m)
                else:
                    cols = cross_grid()[:, _idx(bt.out, dev)]             # (Q, G, m, m)
                    put(env["v"], bt.out, cols.permute(1, 0, 3, 2))       # (G, Q, m, m)
            elif op == sch.VTRSV:
                sol = _trsv_batch(take(packed, bt.a), take(env["v"], bt.out), False)
                put(env["v"], bt.out, sol)
            elif op == sch.VGEMV:
                upd = matrix_product("gab,gqbc->gqac", take(packed, bt.a), take(env["v"], bt.b), batched)
                add(env["v"], bt.out, -upd)
            elif op == sch.GRAM:
                w = matrix_product("ipab,iqac->pqbc", env["v"], env["v"], batched)
                env["prior"] -= w.reshape(lead + (q_tiles * q_tiles, m, m))
            else:
                raise ValueError(op)
    return env


def run_solve(
    lpacked: torch.Tensor,
    rhs: torch.Tensor,
    *,
    lower: bool = True,
    n_streams: Optional[int] = None,
    device="cuda",
) -> torch.Tensor:
    """Level-batched triangular solve on the packed factor.

    rhs: (M, m) vector chunks or (M, Q, m, mq) matrix tile rows; solved on a
    copy.  ``lower=True`` solves L x = rhs, else L^T x = rhs (reading the
    stored lower tiles transposed).  With lpacked (B, T, m, m) and rhs
    (B, M, m) / (B, M, Q, m, mq) the same Plan solves B systems at once.
    """
    dev = resolve_device(device)
    lpacked = torch.as_tensor(lpacked, device=dev)
    # a row-major copy whatever layout comes in (the warm tails hand over a permuted K_* grid), so
    # that each level's gathers and scatters move whole contiguous tiles
    rhs = torch.as_tensor(rhs, device=dev).clone(memory_format=torch.contiguous_format)
    batched = lpacked.ndim == 4
    take, put, add = _env_ops(dev, batched)
    m_tiles = rhs.shape[1] if batched else rhs.shape[0]
    if tiling.num_packed_tiles(m_tiles) != lpacked.shape[-3]:
        raise ValueError(
            f"rhs rows {m_tiles} inconsistent with packed store {tuple(lpacked.shape)}"
        )
    plan = solve_plan(m_tiles, lower=lower, n_streams=n_streams)
    transpose = not lower
    matrix = rhs.ndim == (5 if batched else 4)
    if matrix:
        ein = "gba,gqbc->gqac" if transpose else "gab,gqbc->gqac"
        product = functools.partial(matrix_product, ein, batched=batched)
    else:
        z = "z" if batched else ""
        product = functools.partial(torch.einsum, f"{z}gba,{z}gb->{z}ga" if transpose else f"{z}gab,{z}gb->{z}ga")
    for level in plan.levels:
        for bt in level:
            if bt.op == sch.TRSV:
                put(rhs, bt.out, _trsv_batch(take(lpacked, bt.a), take(rhs, bt.out), transpose))
            else:
                add(rhs, bt.out, -product(take(lpacked, bt.a), take(rhs, bt.b)))
    return rhs


@functools.lru_cache(maxsize=None)
def lowrank_plan(mu_tiles: int, n_tiles: int, n_streams: Optional[int] = None) -> Plan:
    """Compile the LRGEMM bulk family into one batched launch.

    A single level of ``mu_tiles * n_tiles`` independent tile contractions
    over the K_un grid; like every ``BULK_OPS`` family it is never chunked by
    the stream pool.  ``out`` holds the c chunk rows, ``a`` the flat K_un
    slots and ``b`` the training chunks.
    """
    tasks = tuple(sch.lowrank_tasks(mu_tiles, n_tiles))
    batch = Batch(
        sch.LRGEMM,
        tasks,
        out=_arr([p for _, p, _, _ in tasks]),
        a=_arr([p * n_tiles + j for _, p, j, _ in tasks]),
        b=_arr([j for _, _, j, _ in tasks]),
    )
    return Plan("lowrank", mu_tiles, n_streams, ((batch,),))


def run_lowrank_contraction(
    kun: torch.Tensor,
    yc: torch.Tensor,
    *,
    n_streams: Optional[int] = None,
    device="cuda",
) -> torch.Tensor:
    """c = K_un y through the LRGEMM family: c_p = sum_j K_un[p, j] y_j.

    ``kun`` (MU, M, m, mb) cross-covariance tile grid (rows = inducing
    points, columns = training points), ``yc`` (M, mb) training chunks.  One
    ``ops.lrgemm`` launch per plan batch reads the tiles of the flat grid
    where they lie (the plan's ``a`` index is the identity, so no gathered
    copy of the grid is made), then one ``index_add_`` into the (MU, m)
    output.  Padded K_un columns are assembled as zero, so padding needs no
    mask here.  With kun (B, MU, M, m, mb) and yc (B, M, mb) the index
    vectors are offset per problem (a + b * MU * M, b + b * M), so one
    launch covers the B problems' tiles.
    """
    dev = resolve_device(device)
    kun = torch.as_tensor(kun, device=dev)
    yc = torch.as_tensor(yc, device=dev).to(kun.dtype).contiguous()
    batched = kun.ndim == 5
    mu_tiles, n_tiles, m, mb = kun.shape[-4:]
    nb = kun.shape[0] if batched else 1
    plan = lowrank_plan(mu_tiles, n_tiles, n_streams)
    kflat = kun.reshape(nb * mu_tiles * n_tiles, m, mb).contiguous()
    vflat = yc.reshape(nb * n_tiles, mb)
    out = torch.zeros((nb, mu_tiles, m), dtype=kun.dtype, device=dev)
    _, _, add = _env_ops(dev, True)
    for level in plan.levels:
        for bt in level:
            a, b = _idx(bt.a, dev), _idx(bt.b, dev)
            if batched:
                base = torch.arange(nb, device=dev)[:, None]
                a = (a[None] + base * (mu_tiles * n_tiles)).reshape(-1)
                b = (b[None] + base * n_tiles).reshape(-1)
            add(out, bt.out, ops.lrgemm(kflat, vflat, a, b).reshape(nb, -1, m))
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# Streaming updates: block Cholesky append / rank update.
#
# The append plan's buffer environment:
#   the packed store (T_store, m, m)  the frozen existing factor (read-only)
#   "row"  (R + 1, m, m)              the appended tile-row; slot R is the corner
# plus the read-only feature chunks xc and the new row chunk x_row.  The
# rank-update plan's environment:
#   the packed store (T', m, m)       the factor, rewritten column by column
#   "w"    (M', m, m)                 the rank-b carry blocks
#   "xaux/yaux/caux" (M', m, m)       per-column X / Y / C auxiliaries
# Every buffer takes the optional leading problem axis B.
# ---------------------------------------------------------------------------


def _append_batch(op: str, tasks: Sequence[sch.Task], r_tiles: int, m_store: int) -> Batch:
    """Gather/scatter indices of one append batch.

    The packed store may hold ``m_store`` tile-rows with ``m_store >
    r_tiles`` (refilling a partially padded trailing row reads only the
    frozen prefix rows < R but indexes slots of the full store).
    """
    slot = tiling.packed_index
    tasks = tuple(tasks)
    if op in (sch.UASM, sch.UASMD):
        cols = _arr([i for _, i, _, _ in tasks])
        return Batch(op, tasks, out=cols, a=cols)
    if op == sch.UTRSM:
        rows = _arr([i for _, i, _, _ in tasks])
        diag = _arr([slot(i, i, m_store) for _, i, _, _ in tasks])
        return Batch(op, tasks, out=rows, a=diag, b=rows)
    if op == sch.UGEMM:  # row_i -= row_j L(i,j)^T
        tgt = _arr([i for _, i, _, _ in tasks])
        src = _arr([j for _, _, j, _ in tasks])
        til = _arr([slot(i, j, m_store) for _, i, j, _ in tasks])
        return Batch(op, tasks, out=tgt, a=tgt, b=src, c=til)
    if op == sch.USYRK:  # corner -= row_i row_i^T
        tgt = _arr([r_tiles] * len(tasks))
        panel = _arr([i for _, i, _, _ in tasks])
        return Batch(op, tasks, out=tgt, a=tgt, b=panel)
    if op == sch.UPOTRF:
        d = _arr([r_tiles])
        return Batch(op, tasks, out=d, a=d)
    raise ValueError(op)


@functools.lru_cache(maxsize=None)
def update_append_plan(r_tiles: int, m_store: int, n_streams: Optional[int] = None) -> Plan:
    """Compile the one-tile-row append DAG into batched launches."""
    if n_streams is None:
        schedule = sch.build_update_schedule(r_tiles, kind="update_append")
    else:
        schedule = sch.build_wavefront_schedule(r_tiles, n_streams, kind="update_append")
    levels = []
    for level in schedule.levels:
        batches = []
        for op, tasks in sch.split_by_op(level).items():
            width = None if op in sch.BULK_OPS else n_streams
            for chunk in sch.chunk_tasks(tasks, width):
                batches.append(_append_batch(op, chunk, r_tiles, m_store))
        levels.append(tuple(batches))
    return Plan("update_append", r_tiles, n_streams, tuple(levels))


def run_append(
    lpacked: torch.Tensor,
    xc: torch.Tensor,
    x_row: torch.Tensor,
    params,
    r_tiles: int,
    n_valid_new,
    *,
    n_streams: Optional[int] = None,
    update_dtype=None,
    batch_dispatch: str = "flat",
    kernel=None,
    device="cuda",
) -> torch.Tensor:
    """Solve one appended tile-row against the frozen factor.

    lpacked: the existing packed factor (T_store, m, m); xc the matching
    padded feature chunks (M_store, m, D); x_row (m, D) the padded chunk of
    the appended row; ``r_tiles`` the number of frozen prefix rows the new
    row is solved against (``r_tiles == M_store`` grows the factor,
    ``r_tiles < M_store`` recomputes tile-row ``r_tiles`` of the store: the
    trailing partially padded row, or any interior row of a ragged fleet's
    sweep, see ``update.extend_state_ragged``).  ``n_valid_new`` is the
    valid observation count after the append, an int or a (B,) tensor;
    both axes of the row's covariance tiles are masked with it, so a
    problem whose frontier lies at or below ``r_tiles * m`` reproduces its
    identity padding.  Every operand takes the leading problem axis B.

    Returns the row buffer ((B,) R + 1, m, m): the R solved off-diagonal
    tiles followed by the factored corner.  The inputs are only read; the
    caller scatters the row into a grown or refilled copy of the store
    (``tiling.grow_packed_indices`` / ``tiling.replace_row_indices``).
    """
    dev = resolve_device(device)
    kernel = km.resolve_kernel(kernel)
    lpacked = torch.as_tensor(lpacked, device=dev)
    xc = torch.as_tensor(xc, device=dev)
    x_row = torch.as_tensor(x_row, device=dev)
    batched = xc.ndim == 4
    m_store, m = xc.shape[-3], xc.shape[-2]
    if not 0 <= r_tiles <= m_store:
        raise ValueError(
            f"r_tiles must be in [0, m_store] = [0, {m_store}] "
            f"(m_store grows, less refills a row in place); got {r_tiles}"
        )
    if tiling.num_packed_tiles(m_store) != lpacked.shape[-3]:
        raise ValueError(
            f"feature chunks ({m_store} tiles) inconsistent with packed store {tuple(lpacked.shape)}"
        )
    plan = update_append_plan(r_tiles, m_store, n_streams)
    if obs.enabled():
        record_dispatch("run_append", plan, device=dev, batched=batched)
    lead = (xc.shape[0],) if batched else ()
    take, put, _ = _env_ops(dev, batched)
    n_valid_new = _frontier(n_valid_new, dev)
    table = ops.cov_descriptor(kernel, params, xc.shape[-1], lpacked.dtype, dev)
    if batched:
        cov_fn = functools.partial(_cov_batch_fn_batched, table=table, mode=batch_dispatch)
    else:
        cov_fn = functools.partial(_cov_batch_fn, table=table)
    crossf = cov_fn(params, n_valid_new, n_valid_new, False, kernel)
    diagf = cov_fn(params, n_valid_new, n_valid_new, True, kernel)
    potrf = _tile_dispatch(ops.potrf, batched, batch_dispatch)
    trsm = _tile_dispatch(ops.trsm, batched, batch_dispatch)
    trail = _tile_dispatch(lambda c, a, b: ops.trail(c, a, b, update_dtype), batched, batch_dispatch)
    row = torch.zeros(lead + (r_tiles + 1, m, m), dtype=lpacked.dtype, device=dev)
    row0 = r_tiles * m

    def bcast_row(g):  # the row chunk, repeated for each gathered tile
        x = x_row.unsqueeze(-3)
        return x.expand(x.shape[:-3] + (g,) + x.shape[-2:]).contiguous()

    for level in plan.levels:
        for bt in level:
            if bt.op == sch.UASM:
                tiles = crossf(bcast_row(bt.size), take(xc, bt.a), row0, _idx(bt.a, dev) * m)
                put(row, bt.out, tiles)
            elif bt.op == sch.UASMD:
                put(row, bt.out, diagf(bcast_row(1), bcast_row(1), row0, row0))
            elif bt.op == sch.UTRSM:
                put(row, bt.out, trsm(take(lpacked, bt.a), take(row, bt.b)))
            elif bt.op == sch.UGEMM:
                put(row, bt.out, trail(take(row, bt.a), take(row, bt.b), take(lpacked, bt.c)))
            elif bt.op == sch.USYRK:
                pb = take(row, bt.b)
                put(row, bt.out, trail(take(row, bt.a), pb, pb))
            elif bt.op == sch.UPOTRF:
                put(row, bt.out, potrf(take(row, bt.a)))
            else:
                raise ValueError(bt.op)
    return row


# -- rank-b up/downdate ------------------------------------------------------


def _rank_batch(op: str, tasks: Sequence[sch.Task], m: int) -> Batch:
    """Gather/scatter indices of one rank-update batch."""
    slot = tiling.packed_index
    tasks = tuple(tasks)
    if op == sch.UPREP:
        rows = _arr([i for _, i, _, _ in tasks])
        diag = _arr([slot(i, i, m) for _, i, _, _ in tasks])
        return Batch(op, tasks, out=rows, a=diag)
    if op == sch.UPROW:  # L'(i,j) = L(i,j) X_j^T + s W_i Y_j^T
        tgt = _arr([slot(i, j, m) for _, i, j, _ in tasks])
        wrows = _arr([i for _, i, _, _ in tasks])
        cols = _arr([j for _, _, j, _ in tasks])
        return Batch(op, tasks, out=tgt, a=tgt, b=wrows, c=cols)
    if op == sch.UCARRY:  # W_i <- (W_i - L'(i,j) Y_j) C_j^{-T}
        wrows = _arr([i for _, i, _, _ in tasks])
        til = _arr([slot(i, j, m) for _, i, j, _ in tasks])
        cols = _arr([j for _, _, j, _ in tasks])
        return Batch(op, tasks, out=wrows, a=til, b=wrows, c=cols)
    raise ValueError(op)


@functools.lru_cache(maxsize=None)
def update_rank_plan(m_tiles: int, n_streams: Optional[int] = None) -> Plan:
    """Compile the blocked cholupdate sweep into batched launches."""
    if n_streams is None:
        schedule = sch.build_update_schedule(m_tiles, kind="update_rank")
    else:
        schedule = sch.build_wavefront_schedule(m_tiles, n_streams, kind="update_rank")
    return _compile(schedule, n_streams, _rank_batch)


def get_update_ops(sign: float):
    """(uprep, uprow, ucarry) stack ops of the rank-update sweep.

    ``sign=+1.0``: L' L'^T = L L^T + W W^T (eviction of a leading window is
    a positive update of the trailing factor).  ``sign=-1.0``: the true
    hyperbolic downdate L L^T - W W^T; its Cholesky heads go NaN when the
    downdated matrix is not positive definite (callers check, see
    :mod:`repro_torch.core.update`).  Both factorizations of UPREP go to
    ``ops.potrf`` and UCARRY to ``ops.carry_update``; the triangular solves
    and products around them are plain torch.
    """

    def uprep(ljj, wj):
        d = ljj @ ljj.mT + sign * (wj @ wj.mT)
        lnew = ops.potrf(d)
        x = torch.linalg.solve_triangular(lnew, ljj, upper=False)
        y = torch.linalg.solve_triangular(lnew, wj, upper=False)
        eye = torch.eye(ljj.shape[-1], dtype=ljj.dtype, device=ljj.device)
        c = ops.potrf(eye - sign * (y.mT @ y))
        return lnew, x, y, c

    def uprow(lij, wi, xj, yj):
        return (lij @ xj.mT + sign * (wi @ yj.mT)).to(lij.dtype)

    return uprep, uprow, ops.carry_update


def run_rank_update(
    lpacked: torch.Tensor,
    w: torch.Tensor,
    *,
    sign: float = 1.0,
    n_streams: Optional[int] = None,
    batch_dispatch: str = "flat",
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked rank-b up/downdate: L' L'^T = L L^T + sign * W W^T.

    lpacked (T, m, m) packed factor; w (M, m, m) carry blocks (one per
    tile-row; unused trailing columns of a rank-b < m carry must be zero),
    both with the optional leading problem axis B.  Works on copies of both
    and returns (new factor, final carry).  NaNs in the new factor signal a
    failed (non-PD) downdate.
    """
    dev = resolve_device(device)
    lpacked = torch.as_tensor(lpacked, device=dev).clone()
    w = torch.as_tensor(w, device=dev).clone()
    batched = lpacked.ndim == 4
    m_tiles = w.shape[1] if batched else w.shape[0]
    if tiling.num_packed_tiles(m_tiles) != lpacked.shape[-3]:
        raise ValueError(
            f"carry rows {m_tiles} inconsistent with packed store {tuple(lpacked.shape)}"
        )
    take, put, _ = _env_ops(dev, batched)
    plan = update_rank_plan(m_tiles, n_streams)
    if obs.enabled():
        record_dispatch("run_rank_update", plan, device=dev, batched=batched)
    uprep, uprow, ucarry = (_tile_dispatch(f, batched, batch_dispatch) for f in get_update_ops(sign))
    lead = lpacked.shape[:-3]
    xaux = torch.zeros(lead + (m_tiles,) + lpacked.shape[-2:], dtype=lpacked.dtype, device=dev)
    yaux = torch.zeros_like(xaux)
    caux = torch.zeros_like(xaux)
    for level in plan.levels:
        for bt in level:
            if bt.op == sch.UPREP:
                lnew, x, y, c = uprep(take(lpacked, bt.a), take(w, bt.out))
                put(lpacked, bt.a, lnew)
                put(xaux, bt.out, x)
                put(yaux, bt.out, y)
                put(caux, bt.out, c)
            elif bt.op == sch.UPROW:
                put(
                    lpacked,
                    bt.out,
                    uprow(take(lpacked, bt.a), take(w, bt.b), take(xaux, bt.c), take(yaux, bt.c)),
                )
            elif bt.op == sch.UCARRY:
                put(
                    w,
                    bt.out,
                    ucarry(
                        take(w, bt.b), take(lpacked, bt.a), take(yaux, bt.c), take(caux, bt.c)
                    ).to(w.dtype),
                )
            else:
                raise ValueError(bt.op)
    return lpacked, w


obs.register_cache("executor.cholesky_plan", cholesky_plan)
obs.register_cache("executor.solve_plan", solve_plan)
obs.register_cache("executor.program_plan", program_plan)
obs.register_cache("executor.lowrank_plan", lowrank_plan)
obs.register_cache("executor.update_append_plan", update_append_plan)
obs.register_cache("executor.update_rank_plan", update_rank_plan)
