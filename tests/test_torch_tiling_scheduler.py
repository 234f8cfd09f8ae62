"""Port parity: tiling helpers, task DAGs, schedules and compiled plans.

The port keeps its own copies of ``repro.core.tiling`` and
``repro.core.scheduler``; these tests hold them, and the executor's plans,
to the JAX package's on the same inputs.  The last tests check that the
port and its smoke script import neither JAX nor the ``repro`` package.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as jex
from repro.core import scheduler as jsch
from repro.core import tiling as jtil
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import executor as tex
from repro_torch.core import scheduler as tsch
from repro_torch.core import tiling as ttil

M_TILES = [1, 2, 3, 5, 8, 16]
STREAMS = [None, 1, 2, 5]


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(64, 16), (50, 8), (7, 8)])
def test_pad_and_tile_match_reference(rng, n, m):
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(
        ttil.pad_features(torch.from_numpy(x), m).numpy(), np.asarray(jtil.pad_features(x, m))
    )
    np.testing.assert_array_equal(
        ttil.pad_vector(torch.from_numpy(y), m).numpy(), np.asarray(jtil.pad_vector(y, m))
    )
    yc = ttil.pad_vector(torch.from_numpy(y), m)
    v = ttil.untile_vector(yc)
    np.testing.assert_array_equal(ttil.tile_vector(v, m).numpy(), yc.numpy())


@pytest.mark.parametrize("m_tiles,m", [(1, 8), (3, 8), (4, 16)])
def test_pack_unpack_match_reference(rng, m_tiles, m):
    n = m_tiles * m
    a = rng.standard_normal((n, n)).astype(np.float32)
    a = a + a.T
    packed = ttil.pack_lower(torch.from_numpy(a), m)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jtil.pack_lower(jnp.asarray(a), m)))
    for fill in ("lower", "symmetric"):
        np.testing.assert_array_equal(
            ttil.unpack_lower(packed, fill=fill).numpy(),
            np.asarray(jtil.unpack_lower(jnp.asarray(packed.numpy()), fill=fill)),
        )
    np.testing.assert_array_equal(ttil.unpack_lower(packed, fill="symmetric").numpy(), a)
    grid = ttil.tile_dense(torch.from_numpy(a), m)
    np.testing.assert_array_equal(ttil.untile_dense(grid).numpy(), a)


def test_packed_index_and_coords_match_reference():
    for mt in M_TILES:
        assert ttil.num_packed_tiles(mt) == jtil.num_packed_tiles(mt)
        rows, cols = ttil._packed_coords(mt)
        jrows, jcols = jtil._packed_coords(mt)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(cols, jcols)
        for i, j in zip(rows, cols):
            assert ttil.packed_index(int(i), int(j), mt) == jtil.packed_index(int(i), int(j), mt)
    with pytest.raises(ValueError):
        ttil.packed_index(0, 1, 3)


# ---------------------------------------------------------------------------
# task DAGs, ASAP levels and wavefront waves
# ---------------------------------------------------------------------------


def _levels(schedule):
    return [sorted(level) for level in schedule.levels]


@pytest.mark.parametrize("m_tiles", M_TILES)
def test_cholesky_and_solve_schedules_match_reference(m_tiles):
    assert tsch.all_tasks(m_tiles) == jsch.all_tasks(m_tiles)
    t, j = tsch.build_schedule(m_tiles), jsch.build_schedule(m_tiles)
    assert _levels(t) == _levels(j)
    assert (t.critical_path, t.n_tasks, t.max_width(), t.op_counts()) == (
        j.critical_path, j.n_tasks, j.max_width(), j.op_counts()
    )
    for lower in (True, False):
        assert tsch.solve_tasks(m_tiles, lower=lower) == jsch.solve_tasks(m_tiles, lower=lower)
        assert _levels(tsch.build_solve_schedule(m_tiles, lower=lower)) == _levels(
            jsch.build_solve_schedule(m_tiles, lower=lower)
        )


@pytest.mark.parametrize("uncertainty", [False, True])
@pytest.mark.parametrize("m_tiles,q_tiles", [(1, 1), (3, 2), (5, 4), (16, 3)])
def test_program_schedule_matches_reference(m_tiles, q_tiles, uncertainty):
    kw = dict(uncertainty=uncertainty)
    assert tsch.program_tasks(m_tiles, q_tiles, **kw) == jsch.program_tasks(m_tiles, q_tiles, **kw)
    for t in tsch.program_tasks(m_tiles, q_tiles, **kw):
        assert tsch.program_deps(t, m_tiles, q_tiles) == jsch.program_deps(t, m_tiles, q_tiles)
    assert _levels(tsch.build_program_schedule(m_tiles, q_tiles, **kw)) == _levels(
        jsch.build_program_schedule(m_tiles, q_tiles, **kw)
    )


@pytest.mark.parametrize("m_tiles", [1, 3, 6])
def test_nlml_schedule_task_counts_and_sizes_match_reference(m_tiles):
    """The API of the reference's scheduler and tiling that callers of both reach: the NLML
    prefix schedule, the closed-form task counts, packed column ranges and store sizes."""
    t, j = tsch.build_nlml_schedule(m_tiles), jsch.build_nlml_schedule(m_tiles)
    assert _levels(t) == _levels(j) and (t.kind, t.q_tiles, t.uncertainty) == (j.kind, j.q_tiles, j.uncertainty)
    assert tsch.theoretical_task_counts(m_tiles) == jsch.theoretical_task_counts(m_tiles)
    assert tsch.theoretical_task_counts(m_tiles) == tsch.build_schedule(m_tiles).op_counts()
    for col in range(m_tiles):
        assert ttil.column_slice(col, m_tiles) == jtil.column_slice(col, m_tiles)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64), (torch.bfloat16, jnp.bfloat16)):
        assert ttil.packed_bytes(m_tiles, 16, tdt) == jtil.packed_bytes(m_tiles, 16, jdt)
        assert ttil.dense_bytes(m_tiles * 16, tdt) == jtil.dense_bytes(m_tiles * 16, jdt)
    assert ttil.packed_bytes(m_tiles, 16) == jtil.packed_bytes(m_tiles, 16)


@pytest.mark.parametrize("n_streams", [1, 2, 5])
@pytest.mark.parametrize("m_tiles", [2, 5, 16])
def test_wavefront_waves_match_reference(m_tiles, n_streams):
    for kind in ("cholesky", "forward", "backward"):
        t = tsch.build_wavefront_schedule(m_tiles, n_streams, kind=kind)
        j = jsch.build_wavefront_schedule(m_tiles, n_streams, kind=kind)
        assert [list(w) for w in t.levels] == [list(w) for w in j.levels], kind
    for unc in (False, True):
        kw = dict(kind="program", q_tiles=3, uncertainty=unc)
        t = tsch.build_wavefront_schedule(m_tiles, n_streams, **kw)
        j = jsch.build_wavefront_schedule(m_tiles, n_streams, **kw)
        assert [list(w) for w in t.levels] == [list(w) for w in j.levels]


@pytest.mark.parametrize("n_streams", [1, 2, 5])
def test_chunk_split_and_dispatch_group_match_reference(n_streams):
    tasks = tsch.all_tasks(6)
    assert tsch.chunk_tasks(tasks, n_streams) == jsch.chunk_tasks(tasks, n_streams)
    assert tsch.split_by_op(tasks) == jsch.split_by_op(tasks)
    for op in (tsch.SYRK, tsch.GEMM, tsch.POTRF, tsch.TRSM, tsch.ASSEMBLE, tsch.GRAM):
        assert tsch.dispatch_group(op) == jsch.dispatch_group(op)
    assert tsch.BULK_OPS <= jsch.BULK_OPS


# ---------------------------------------------------------------------------
# compiled plans and launch counts
# ---------------------------------------------------------------------------


def _plan_digest(plan):
    out = []
    for level in plan.levels:
        lvl = []
        for b in level:
            arrs = tuple(
                None if x is None else tuple(int(v) for v in x) for x in (b.out, b.a, b.b, b.c)
            )
            lvl.append((b.op, tuple(b.tasks), arrs))
        out.append(lvl)
    return out


@pytest.mark.parametrize("n_streams", STREAMS)
@pytest.mark.parametrize("m_tiles", [1, 3, 8, 16])
def test_plans_match_reference(m_tiles, n_streams):
    assert _plan_digest(tex.cholesky_plan(m_tiles, n_streams)) == _plan_digest(
        jex.cholesky_plan(m_tiles, n_streams)
    )
    for lower in (True, False):
        assert _plan_digest(tex.solve_plan(m_tiles, lower=lower, n_streams=n_streams)) == _plan_digest(
            jex.solve_plan(m_tiles, lower=lower, n_streams=n_streams)
        )
    for unc in (False, True):
        tp = tex.program_plan(m_tiles, 2, unc, n_streams)
        jp = jex.program_plan(m_tiles, 2, unc, n_streams)
        assert _plan_digest(tp) == _plan_digest(jp)
        assert tex.plan_wave_stats(tp) == jex.plan_wave_stats(jp)
        assert tex.staged_launch_count(m_tiles, uncertainty=unc, n_streams=n_streams) == (
            jex.staged_launch_count(m_tiles, uncertainty=unc, n_streams=n_streams)
        )


def test_launches_by_op_of_the_main_path():
    """gp_16k (M = Q = 32): one launch per level for POTRF, TRSM and TRAIL."""
    plan = tex.program_plan(32, 32, True, None)
    by_op = plan.launches_by_op()
    assert (by_op[tsch.POTRF], by_op[tsch.TRSM], by_op[tex.TRAIL]) == (32, 31, 31)
    assert by_op[tsch.ASSEMBLE] == by_op[tsch.CROSS] == by_op[tsch.PRIOR] == 1
    assert tex.program_plan(32, 32, False, None).launches_by_op().get(tsch.PRIOR, 0) == 0


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_port_imports_neither_jax_nor_repro():
    root = Path(__file__).resolve().parents[1]
    files = (sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
             + sorted((root / "examples_torch").glob("*.py")))
    assert len(files) > 15 and sum(f.parent.name == "examples_torch" for f in files) == 5
    offenders = {
        str(f.relative_to(root)): _IMPORT.findall(f.read_text())
        for f in files
        if _IMPORT.search(f.read_text())
    }
    assert offenders == {}


_BLOCKED_IMPORT = """
import importlib, pkgutil, runpy, sys
sys.modules["jax"] = None      # any import of jax or repro now raises ImportError
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1] + "/src")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1] + "/chip_smoke.py", run_name="chip_smoke")
sys.path.insert(0, sys.argv[1])
for name in ("quickstart", "gp_system_identification", "serve_gp", "composite_workload", "train_lm"):
    importlib.import_module("examples_torch." + name)
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    """Every module of the port, chip_smoke.py and the examples import in a fresh
    interpreter in which ``jax`` and ``repro`` cannot be imported."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(root)],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # core/ and kernels/ modules, all walked
