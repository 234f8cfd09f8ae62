"""Tile-task DAG scheduler: the static analogue of HPX ``hpx::dataflow``.

A copy of the Cholesky, triangular-solve, whole-pipeline program,
streaming-update (append, rank update) and low-rank (LRGEMM) DAGs of
``repro/core/scheduler.py`` (that module is pure Python, but importing it
runs ``repro/core/__init__.py``, which imports JAX, so the port keeps its
own copy).

The paper expresses the tiled Cholesky as a dataflow graph: each tile is
wrapped in an ``hpx::shared_future`` and POTRF/TRSM/SYRK/GEMM tasks fire as
their inputs become ready, spread round-robin over a pool of CUDA streams.
This module builds the same DAG ahead of time and derives:

* ``levels`` — an ASAP level schedule: level k holds all tasks whose longest
  dependency chain has length k.  Tasks inside one level are independent.
* ``chunk_tasks(level, n_streams)`` — splits a level into round-robin chunks
  of at most ``n_streams`` tasks; the executor issues one batched kernel per
  chunk.  ``n_streams=1`` is fully sequential; ``None`` batches whole levels.
* :func:`build_wavefront_schedule` — the finite-stream-pool list schedule
  (critical-path-first waves of at most ``n_streams`` ready tasks).

:func:`build_program_schedule` fuses the whole prediction pipeline —
covariance assembly, Cholesky, both substitutions, cross covariance, the
predictive mean and optionally the full-covariance tail — into one DAG with
cross-stage edges, so e.g. ``TRSV(0)`` depends only on ``POTRF@col0``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Task encodings: (op, i, j, k).  k is only used by GEMM.
POTRF = "potrf"
TRSM = "trsm"
SYRK = "syrk"
GEMM = "gemm"

# Triangular-solve ops: TRSV solves the diagonal tile of row i; GEMV updates
# pending row i with solved row j (tile (i, j) for forward, (j, i)^T backward).
TRSV = "trsv"
GEMV = "gemv"

# Whole-pipeline program ops.
ASSEMBLE = "assemble"    # packed training-covariance tile (i, j)
CROSS = "cross"          # cross-covariance tile K_*[p, q] (test row p, train col q)
PRIOR = "prior"          # prior test-covariance tile K_{X̂,X̂}[p, q]
TRSV_B = "trsv_b"        # backward diagonal solve of row i (alpha buffer)
GEMV_B = "gemv_b"        # backward propagation a_i -= L_ji^T a_j
XGEMV = "xgemv"          # predictive-mean row p: mean_p = sum_q K_*[p,q] alpha_q
VINIT = "vinit"          # uncertainty workspace row i: V_i,q <- K_*[q,i]^T
VTRSV = "vtrsv"          # matrix forward solve, diagonal tile of row i
VGEMV = "vgemv"          # matrix forward propagation V_i -= L_ij V_j
GRAM = "gram"            # Sigma = prior - V^T V (single closing task)

# Streaming-update ops (block Cholesky append / rank update).
#
# *Append* ("update_append"): grow the factor by one tile-row R of new
# observations against the frozen existing factor L (R tile-rows):
#   row_j = K(R, j) L(j,j)^{-T} after  row_j -= sum_{k<j} row_k L(j,k)^T
#   corner = chol(K(R, R) - sum_j row_j row_j^T)
#
# *Rank update* ("update_rank"): L' L'^T = L L^T + s W W^T for a tile-column
# carry W, as the blocked cholupdate recurrence (per column j):
#   L'(j,j) = chol(L(j,j) L(j,j)^T + s W_j W_j^T)
#   X_j = L'(j,j)^{-1} L(j,j);  Y_j = L'(j,j)^{-1} W_j
#   C_j = chol(I - s Y_j^T Y_j)
#   L'(i,j) = L(i,j) X_j^T + s W_i Y_j^T                          (i > j)
#   W_i    <- (W_i - L'(i,j) Y_j) C_j^{-T}                        (i > j)
UASM = "uasm"            # assemble cross tile K(x_row, x_j) of the new row
UASMD = "uasmd"          # assemble the new diagonal (corner) tile
UTRSM = "utrsm"          # row_j <- row_j L(j,j)^{-T}
UGEMM = "ugemm"          # row_j -= row_k L(j,k)^T
USYRK = "usyrk"          # corner -= row_j row_j^T
UPOTRF = "upotrf"        # corner <- chol(corner)
UPREP = "uprep"          # column head: L'(j,j) + the X/Y/C auxiliaries
UPROW = "uprow"          # L'(i,j) = L(i,j) X_j^T + s W_i Y_j^T
UCARRY = "ucarry"        # W_i <- (W_i - L'(i,j) Y_j) C_j^{-T}

# Low-rank (Nystrom) tier op: the n-side contraction of the inducing system.
# One tile task per (inducing row p, training column j) of the K_un grid;
# every task is independent, so the whole family is one bulk launch.
LRGEMM = "lrgemm"        # c_p += K_un[p, j] @ y_j

Task = Tuple[str, int, int, int]

# Ops that the wavefront scheduler does NOT count against the stream pool:
# the pool models per-stream tile BLAS handles, whereas these are single
# batched launches in the executor no matter how many tiles they cover.
# They still enter waves as soon as their dependencies resolve.
BULK_OPS = frozenset({ASSEMBLE, CROSS, PRIOR, VINIT, XGEMV, GRAM, UASM, UASMD, LRGEMM})

# SYRK is GEMM with both panels equal, so the executor fuses both into one
# trailing-update launch per level (executor.TRAIL).
TRAIL_GROUP = "trail"


def dispatch_group(op: str) -> str:
    return TRAIL_GROUP if op in (SYRK, GEMM) else op


def _deps(task: Task, m_tiles: int) -> List[Task]:
    """Direct dependencies of a task in the right-looking tiled Cholesky.

      POTRF(J,J)   needs SYRK(J,J) of step J-1
      TRSM(I,J)    needs POTRF(J,J) and GEMM(I,J) of step J-1
      SYRK(I,I)@J  needs TRSM(I,J) and SYRK(I,I) of step J-1
      GEMM(I,K)@J  needs TRSM(I,J), TRSM(K,J) and GEMM(I,K) of step J-1
    """
    op, i, j, k = task
    deps: List[Task] = []
    if op == POTRF:
        if j > 0:
            deps.append((SYRK, j, j - 1, -1))
    elif op == TRSM:
        deps.append((POTRF, j, j, -1))
        if j > 0:
            deps.append((GEMM, i, j - 1, j))
    elif op == SYRK:
        deps.append((TRSM, i, j, -1))
        if j > 0:
            deps.append((SYRK, i, j - 1, -1))
    elif op == GEMM:
        deps.append((TRSM, i, j, -1))
        deps.append((TRSM, k, j, -1))
        if j > 0:
            deps.append((GEMM, i, j - 1, k))
    else:
        raise ValueError(op)
    return deps


def all_tasks(m_tiles: int) -> List[Task]:
    """Every task of the factorization, in the paper's Fig. 1 program order."""
    tasks: List[Task] = []
    for j in range(m_tiles):
        tasks.append((POTRF, j, j, -1))
        for i in range(j + 1, m_tiles):
            tasks.append((TRSM, i, j, -1))
        for i in range(j + 1, m_tiles):
            tasks.append((SYRK, i, j, -1))
            for k in range(j + 1, i):
                tasks.append((GEMM, i, j, k))
    return tasks


@dataclasses.dataclass(frozen=True)
class Schedule:
    m_tiles: int
    levels: Tuple[Tuple[Task, ...], ...]
    # "cholesky" | "forward" | "backward" | "program" | "update_append" | "update_rank"
    # | "lowrank"
    kind: str = "cholesky"
    q_tiles: int = 0        # test tile count (program); training tile count (lowrank)
    uncertainty: bool = False  # program includes the full-covariance tail

    @property
    def critical_path(self) -> int:
        return len(self.levels)

    @property
    def n_tasks(self) -> int:
        return sum(len(l) for l in self.levels)

    def max_width(self) -> int:
        return max(len(l) for l in self.levels)

    def op_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for level in self.levels:
            for t in level:
                counts[t[0]] = counts.get(t[0], 0) + 1
        if self.kind == "cholesky":
            for op in (POTRF, TRSM, SYRK, GEMM):
                counts.setdefault(op, 0)
        return counts


def _asap_levels(tasks: Sequence[Task], deps_fn) -> Tuple[Tuple[Task, ...], ...]:
    """ASAP level assignment; ``tasks`` must be in topological order."""
    level_of: Dict[Task, int] = {}
    for t in tasks:
        deps = deps_fn(t)
        level_of[t] = 0 if not deps else 1 + max(level_of[d] for d in deps)
    n_levels = 1 + max(level_of.values()) if level_of else 0
    levels: List[List[Task]] = [[] for _ in range(n_levels)]
    for t in tasks:
        levels[level_of[t]].append(t)
    return tuple(tuple(l) for l in levels)


def build_schedule(m_tiles: int) -> Schedule:
    """ASAP level schedule of the tiled Cholesky DAG."""
    levels = _asap_levels(all_tasks(m_tiles), lambda t: _deps(t, m_tiles))
    return Schedule(m_tiles=m_tiles, levels=levels)


def solve_deps(task: Task, m_tiles: int, *, lower: bool = True) -> List[Task]:
    """Direct dependencies of a triangular-solve task.

    Forward (``L b = y``): TRSV(i) needs GEMV(i, i-1); GEMV(i, j) needs
    TRSV(j) and GEMV(i, j-1).  Backward (``L^T a = b``) mirrors this with
    the recurrence running from row M-1 down.
    """
    op, i, j, _ = task
    deps: List[Task] = []
    if op == TRSV:
        if lower and i > 0:
            deps.append((GEMV, i, i - 1, -1))
        elif not lower and i < m_tiles - 1:
            deps.append((GEMV, i, i + 1, -1))
    elif op == GEMV:
        deps.append((TRSV, j, j, -1))
        if lower and j > 0:
            deps.append((GEMV, i, j - 1, -1))
        elif not lower and j < m_tiles - 1:
            deps.append((GEMV, i, j + 1, -1))
    else:
        raise ValueError(op)
    return deps


def solve_tasks(m_tiles: int, *, lower: bool = True) -> List[Task]:
    """Every task of a tiled triangular solve, in dataflow program order."""
    tasks: List[Task] = []
    cols = range(m_tiles) if lower else reversed(range(m_tiles))
    for j in cols:
        tasks.append((TRSV, j, j, -1))
        rows = range(j + 1, m_tiles) if lower else range(j)
        for i in rows:
            tasks.append((GEMV, i, j, -1))
    return tasks


def build_solve_schedule(m_tiles: int, *, lower: bool = True) -> Schedule:
    """ASAP level schedule of forward (lower) / backward substitution."""
    levels = _asap_levels(
        solve_tasks(m_tiles, lower=lower),
        lambda t: solve_deps(t, m_tiles, lower=lower),
    )
    return Schedule(
        m_tiles=m_tiles, levels=levels, kind="forward" if lower else "backward"
    )


# ---------------------------------------------------------------------------
# The whole-pipeline program DAG.
# ---------------------------------------------------------------------------


def program_tasks(m_tiles: int, q_tiles: int, *, uncertainty: bool = False) -> List[Task]:
    """Every task of the fused prediction pipeline, in topological order."""
    tasks: List[Task] = []
    for j in range(m_tiles):
        for i in range(j, m_tiles):
            tasks.append((ASSEMBLE, i, j, -1))
    for p in range(q_tiles):
        for q in range(m_tiles):
            tasks.append((CROSS, p, q, -1))
    if uncertainty:
        for p in range(q_tiles):
            for q in range(q_tiles):
                tasks.append((PRIOR, p, q, -1))
    tasks += all_tasks(m_tiles)
    tasks += solve_tasks(m_tiles, lower=True)  # forward: TRSV / GEMV
    for op, i, j, k in solve_tasks(m_tiles, lower=False):
        tasks.append((TRSV_B if op == TRSV else GEMV_B, i, j, k))
    for p in range(q_tiles):
        tasks.append((XGEMV, p, -1, -1))
    if uncertainty:
        for i in range(m_tiles):
            tasks.append((VINIT, i, -1, -1))
        for op, i, j, k in solve_tasks(m_tiles, lower=True):
            tasks.append((VTRSV if op == TRSV else VGEMV, i, j, k))
        tasks.append((GRAM, -1, -1, -1))
    return tasks


def program_deps(task: Task, m_tiles: int, q_tiles: int) -> List[Task]:
    """Direct dependencies of a task in the fused prediction program.

    A consumer waits only for the tiles it reads: the last writer of an
    off-diagonal packed tile (i, j) is ``TRSM(i, j)``, of a diagonal tile
    ``POTRF(j)``, of vector row i the forward/backward ``TRSV`` of that row.
    Forward substitution runs in the ``y`` buffer and publishes each solved
    row into ``alpha``, where the backward pass accumulates, so backward
    writes never clobber rows a forward GEMV still reads.
    """
    op, i, j, k = task
    m = m_tiles
    if op in (ASSEMBLE, CROSS, PRIOR):
        return []
    if op == POTRF:
        return [(SYRK, j, j - 1, -1) if j > 0 else (ASSEMBLE, j, j, -1)]
    if op == TRSM:
        return [
            (POTRF, j, j, -1),
            (GEMM, i, j - 1, j) if j > 0 else (ASSEMBLE, i, j, -1),
        ]
    if op == SYRK:
        return [
            (TRSM, i, j, -1),
            (SYRK, i, j - 1, -1) if j > 0 else (ASSEMBLE, i, i, -1),
        ]
    if op == GEMM:
        return [
            (TRSM, i, j, -1),
            (TRSM, k, j, -1),
            (GEMM, i, j - 1, k) if j > 0 else (ASSEMBLE, i, k, -1),
        ]
    if op == TRSV:
        deps = [(POTRF, i, i, -1)]
        if i > 0:
            deps.append((GEMV, i, i - 1, -1))
        return deps
    if op == GEMV:
        deps = [(TRSV, j, j, -1), (TRSM, i, j, -1)]
        if j > 0:
            deps.append((GEMV, i, j - 1, -1))
        return deps
    if op == TRSV_B:
        deps = [(POTRF, i, i, -1), (TRSV, i, i, -1)]
        if i < m - 1:
            deps.append((GEMV_B, i, i + 1, -1))
        return deps
    if op == GEMV_B:
        deps = [(TRSV_B, j, j, -1), (TRSV, i, i, -1), (TRSM, j, i, -1)]
        if j < m - 1:
            deps.append((GEMV_B, i, j + 1, -1))
        return deps
    if op == XGEMV:
        return [(CROSS, i, q, -1) for q in range(m)] + [
            (TRSV_B, q, q, -1) for q in range(m)
        ]
    if op == VINIT:
        return [(CROSS, p, i, -1) for p in range(q_tiles)]
    if op == VTRSV:
        deps = [(VINIT, i, -1, -1), (POTRF, i, i, -1)]
        if i > 0:
            deps.append((VGEMV, i, i - 1, -1))
        return deps
    if op == VGEMV:
        deps = [(VTRSV, j, j, -1), (TRSM, i, j, -1), (VINIT, i, -1, -1)]
        if j > 0:
            deps.append((VGEMV, i, j - 1, -1))
        return deps
    if op == GRAM:
        return [(VTRSV, r, r, -1) for r in range(m)] + [
            (PRIOR, p, q, -1) for p in range(q_tiles) for q in range(q_tiles)
        ]
    raise ValueError(op)


def build_program_schedule(
    m_tiles: int, q_tiles: int, *, uncertainty: bool = False
) -> Schedule:
    """ASAP level schedule of the fused prediction program."""
    tasks = program_tasks(m_tiles, q_tiles, uncertainty=uncertainty)
    levels = _asap_levels(tasks, lambda t: program_deps(t, m_tiles, q_tiles))
    return Schedule(
        m_tiles=m_tiles,
        levels=levels,
        kind="program",
        q_tiles=q_tiles,
        uncertainty=uncertainty,
    )


def build_nlml_schedule(m_tiles: int) -> Schedule:
    """The NLML prefix of the prediction program: ASSEMBLE, the factorization
    and both substitutions (``q_tiles = 0``), the forward program that
    :func:`repro_torch.core.mll.nlml_tiled` differentiates."""
    return build_program_schedule(m_tiles, 0, uncertainty=False)


# ---------------------------------------------------------------------------
# Streaming-update DAGs: block Cholesky append / rank update.
# ---------------------------------------------------------------------------


def append_tasks(r_tiles: int) -> List[Task]:
    """Every task of a one-tile-row block-Cholesky append, in program order.

    ``r_tiles`` is the number of existing factor tile-rows the new row is
    solved against (the new row gets index R = r_tiles).  ``r_tiles=0``
    degenerates to assembling and factoring a single corner tile.
    """
    r = r_tiles
    tasks: List[Task] = []
    for j in range(r):
        tasks.append((UASM, j, -1, -1))
    tasks.append((UASMD, r, -1, -1))
    for j in range(r):
        for k in range(j):
            tasks.append((UGEMM, j, k, -1))
        tasks.append((UTRSM, j, -1, -1))
        tasks.append((USYRK, j, -1, -1))
    tasks.append((UPOTRF, r, -1, -1))
    return tasks


def append_deps(task: Task, r_tiles: int) -> List[Task]:
    """Direct dependencies of an append task.

    The existing factor is a frozen input, so edges only run between the
    new row's own tasks: UGEMM corrections chain before each diagonal
    solve, and the corner accumulates USYRK contributions in program order.
    """
    op, i, j, _ = task
    r = r_tiles
    if op in (UASM, UASMD):
        return []
    if op == UTRSM:  # row_i <- row_i L(i,i)^{-T} after all corrections
        return [(UGEMM, i, i - 1, -1) if i > 0 else (UASM, i, -1, -1)]
    if op == UGEMM:  # row_i -= row_j L(i,j)^T; reads solved row_j
        deps = [(UTRSM, j, -1, -1)]
        deps.append((UGEMM, i, j - 1, -1) if j > 0 else (UASM, i, -1, -1))
        return deps
    if op == USYRK:  # corner -= row_i row_i^T (accumulation chain)
        return [
            (UTRSM, i, -1, -1),
            (USYRK, i - 1, -1, -1) if i > 0 else (UASMD, r, -1, -1),
        ]
    if op == UPOTRF:
        return [(USYRK, r - 1, -1, -1) if r > 0 else (UASMD, r, -1, -1)]
    raise ValueError(op)


def rank_update_tasks(m_tiles: int) -> List[Task]:
    """Every task of a tiled rank-b up/downdate, in program order."""
    tasks: List[Task] = []
    for j in range(m_tiles):
        tasks.append((UPREP, j, -1, -1))
        for i in range(j + 1, m_tiles):
            tasks.append((UPROW, i, j, -1))
        for i in range(j + 1, m_tiles):
            tasks.append((UCARRY, i, j, -1))
    return tasks


def rank_update_deps(task: Task, m_tiles: int) -> List[Task]:
    """Direct dependencies of a rank-update task (blocked cholupdate).

    Row i's carry W_i evolves once per column, so every column-j task on
    row i waits for UCARRY(i, j-1), the last writer of W_i.  UPREP(j)
    writes the new diagonal and the X/Y/C auxiliaries its column reads;
    UPROW(i, j) overwrites L(i, j) in place.
    """
    op, i, j, _ = task
    if op == UPREP:  # reads L(j,j) and the settled carry W_j
        return [(UCARRY, i, i - 1, -1)] if i > 0 else []
    if op == UPROW:
        deps = [(UPREP, j, -1, -1)]
        if j > 0:
            deps.append((UCARRY, i, j - 1, -1))
        return deps
    if op == UCARRY:
        return [(UPROW, i, j, -1), (UPREP, j, -1, -1)]
    raise ValueError(op)


def build_update_schedule(m_tiles: int, *, kind: str = "update_append") -> Schedule:
    """ASAP level schedule of an update DAG.

    ``kind="update_append"``: ``m_tiles`` is the existing row count R the
    appended row solves against.  ``kind="update_rank"``: ``m_tiles`` is the
    size of the factor being up/downdated.
    """
    tasks, deps_fn = _dag(m_tiles, kind)
    return Schedule(m_tiles=m_tiles, levels=_asap_levels(tasks, deps_fn), kind=kind)


def lowrank_tasks(mu_tiles: int, n_tiles: int) -> List[Task]:
    """The LRGEMM bulk family over the (mu_tiles x n_tiles) K_un grid.

    A single level: every tile contraction is independent, so the whole
    family compiles to one batched launch (``BULK_OPS``).
    """
    return [(LRGEMM, p, j, -1) for p in range(mu_tiles) for j in range(n_tiles)]


def lowrank_deps(task: Task) -> List[Task]:
    if task[0] != LRGEMM:
        raise ValueError(task[0])
    return []


def task_deps(task: Task, schedule: Schedule) -> List[Task]:
    """Dependencies of ``task`` under the DAG family of ``schedule.kind``."""
    if schedule.kind == "cholesky":
        return _deps(task, schedule.m_tiles)
    if schedule.kind == "program":
        return program_deps(task, schedule.m_tiles, schedule.q_tiles)
    if schedule.kind == "update_append":
        return append_deps(task, schedule.m_tiles)
    if schedule.kind == "update_rank":
        return rank_update_deps(task, schedule.m_tiles)
    if schedule.kind == "lowrank":
        return lowrank_deps(task)
    return solve_deps(task, schedule.m_tiles, lower=schedule.kind == "forward")


def _dag(m_tiles: int, kind: str, q_tiles: int = 0, uncertainty: bool = False):
    """(tasks in topological order, deps_fn) for a DAG family."""
    if kind == "cholesky":
        return all_tasks(m_tiles), lambda t: _deps(t, m_tiles)
    if kind in ("forward", "backward"):
        lower = kind == "forward"
        return (
            solve_tasks(m_tiles, lower=lower),
            lambda t: solve_deps(t, m_tiles, lower=lower),
        )
    if kind == "program":
        return (
            program_tasks(m_tiles, q_tiles, uncertainty=uncertainty),
            lambda t: program_deps(t, m_tiles, q_tiles),
        )
    if kind == "update_append":
        return append_tasks(m_tiles), lambda t: append_deps(t, m_tiles)
    if kind == "update_rank":
        return rank_update_tasks(m_tiles), lambda t: rank_update_deps(t, m_tiles)
    if kind == "lowrank":
        # q_tiles carries the n-side tile count of the K_un grid
        return lowrank_tasks(m_tiles, q_tiles), lowrank_deps
    raise ValueError(kind)


def _bottom_levels(tasks: Sequence[Task], deps_fn) -> Dict[Task, int]:
    """Longest path from each task to a sink (critical-path priority)."""
    bottom: Dict[Task, int] = {t: 0 for t in tasks}
    for t in reversed(tasks):  # reverse topological order
        for d in deps_fn(t):
            bottom[d] = max(bottom[d], bottom[t] + 1)
    return bottom


def build_wavefront_schedule(
    m_tiles: int,
    n_streams: int,
    *,
    kind: str = "cholesky",
    q_tiles: int = 0,
    uncertainty: bool = False,
) -> Schedule:
    """Finite-stream-pool list schedule: the paper's round-robin pool, static.

      wave k = the <= n_streams ready tasks with the greatest bottom-level
               (longest path to a sink, i.e. critical-path-first priority)

    BULK_OPS tasks ride every wave as soon as they are ready without taking
    pool slots.  Program DAGs also prefer, after the critical-path leader,
    tasks of the leader's dispatch group, so a wave compiles to as few
    batched launches as possible.  Every wave is an antichain, so executing
    waves in sequence is dependency-faithful.
    """
    if n_streams < 1:
        raise ValueError(f"n_streams must be >= 1 or None, got {n_streams}")
    tasks, deps_fn = _dag(m_tiles, kind, q_tiles, uncertainty)
    bottom = _bottom_levels(tasks, deps_fn)
    order = {t: i for i, t in enumerate(tasks)}
    indeg = {t: len(deps_fn(t)) for t in tasks}
    succs: Dict[Task, List[Task]] = {}
    for t in tasks:
        for d in deps_fn(t):
            succs.setdefault(d, []).append(t)

    def push(h, t):
        heapq.heappush(h, (-bottom[t], order[t], t))

    heap: list = []       # pooled tile tasks (<= n_streams per wave)
    bulk_heap: list = []  # batched bulk ops (ride along, see BULK_OPS)
    for t in tasks:
        if indeg[t] == 0:
            push(bulk_heap if t[0] in BULK_OPS else heap, t)
    waves: List[Tuple[Task, ...]] = []
    affinity = kind == "program"
    while heap or bulk_heap:
        wave = [heapq.heappop(bulk_heap)[2] for _ in range(len(bulk_heap))]
        if affinity and heap:
            ready = [heapq.heappop(heap) for _ in range(len(heap))]
            leader = ready[0]
            grp = dispatch_group(leader[2][0])
            same = [e for e in ready[1:] if dispatch_group(e[2][0]) == grp]
            rest = [e for e in ready[1:] if dispatch_group(e[2][0]) != grp]
            picked = [leader] + (same + rest)[: n_streams - 1]
            wave += [e[2] for e in picked]
            for e in same[n_streams - 1 :] + rest[max(n_streams - 1 - len(same), 0) :]:
                heapq.heappush(heap, e)
        else:
            wave += [heapq.heappop(heap)[2] for _ in range(min(n_streams, len(heap)))]
        waves.append(tuple(wave))
        for t in wave:
            for s in succs.get(t, ()):
                indeg[s] -= 1
                if indeg[s] == 0:
                    push(bulk_heap if s[0] in BULK_OPS else heap, s)
    return Schedule(
        m_tiles=m_tiles,
        levels=tuple(waves),
        kind=kind,
        q_tiles=q_tiles,
        uncertainty=uncertainty,
    )


def chunk_tasks(
    tasks: Sequence[Task], n_streams: Optional[int]
) -> List[List[Task]]:
    """Round-robin chunking of one level into groups of <= n_streams tasks."""
    tasks = list(tasks)
    if n_streams is None or n_streams >= len(tasks):
        return [tasks] if tasks else []
    return [tasks[i : i + n_streams] for i in range(0, len(tasks), n_streams)]


def split_by_op(tasks: Iterable[Task]) -> Dict[str, List[Task]]:
    out: Dict[str, List[Task]] = {}
    for t in tasks:
        out.setdefault(t[0], []).append(t)
    return out


def theoretical_task_counts(m_tiles: int) -> Dict[str, int]:
    """Tasks per op family of an M-tile tiled Cholesky, in closed form."""
    m = m_tiles
    return {
        POTRF: m,
        TRSM: m * (m - 1) // 2,
        SYRK: m * (m - 1) // 2,
        GEMM: m * (m - 1) * (m - 2) // 6,
    }
