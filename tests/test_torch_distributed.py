"""Port parity: the block-cyclic distributed Cholesky and GP prediction (``repro_torch.core.distributed``).

The cases of ``tests/test_distributed_gp.py``: n = 128, tile 16 (M = 8).
One module-scoped fixture spawns a 4-rank gloo world on the CPU
(``_torch_dist.World``, a ``FileStore`` of its own, under a timeout)
and runs every case there: the Cholesky on a 2x2 grid, on a 4x1 grid (both
``unroll`` values) and on a 2x2 grid whose rows span two mesh axes
(``row_axes=("pod", "data")``), held to ``np.linalg.cholesky`` at the
reference's 1e-3; the bf16 trailing update at relative error < 0.02; and
``distributed_gp_predict_fn``'s mean and variances against the JAX
package's single-device ``predict(..., full_cov=True)``, run here in
process, at 1e-3.  The layout helpers are held to the JAX functions
in process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import World, distributed_world
from repro.core import distributed as jdist
from repro.core import predict as jpred
from repro.core.kernels_math import SEKernelParams as JSE
from repro_torch.core import distributed as tdist

TOL = 1e-3


@pytest.fixture(scope="module")
def world():
    ranks = World(distributed_world, 4, timeout=150).join()
    return ranks


@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (4, 2), (1, 4)])
def test_cyclic_layout_matches_reference(grid):
    tiles = np.random.default_rng(0).standard_normal((8, 8, 2, 2)).astype(np.float32)
    p, q = grid
    want = np.asarray(jdist.to_cyclic_layout(jnp.asarray(tiles), p, q))
    got = tdist.to_cyclic_layout(torch.from_numpy(tiles), p, q).numpy()
    np.testing.assert_array_equal(got, want)
    back = tdist.from_cyclic_layout(torch.from_numpy(want.copy()), p, q).numpy()
    np.testing.assert_array_equal(back, np.asarray(jdist.from_cyclic_layout(jnp.asarray(want), p, q)))
    np.testing.assert_array_equal(back, tiles)


def test_mesh_is_checked():
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdist.distributed_cholesky_fn(object(), m_tiles=8)
    with pytest.raises(TypeError, match="needs a mesh"):
        tdist.distributed_gp_predict_fn(None, m_tiles=8, tile_size=16, n_valid=128, n_test_valid=32,
                                        params=None)


@pytest.mark.parametrize("case", ["2x2_False", "2x2_True", "4x1_False", "4x1_True", "pod2x2"])
def test_cholesky_matches_numpy(world, case):
    want = np.linalg.cholesky(world[0]["K"].astype(np.float64))
    for rank in world:  # every rank collects the same global factor
        got = rank[f"L_{case}"]
        assert np.abs(got - want).max() < TOL, (case, float(np.abs(got - want).max()))


def test_cholesky_bf16_update(world):
    want = np.linalg.cholesky(world[0]["K"].astype(np.float64))
    got = world[0]["L_bf16"]
    rel = np.abs(got - want).max() / np.abs(got).max()
    assert rel < 0.02, rel
    assert np.abs(got - want).max() > 0  # the update really ran in bf16


def test_predict_matches_jax(world):
    x, y, xt = world[0]["data"]
    nte = xt.shape[0]
    mu_ref, cov_ref = jpred.predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), JSE.paper_defaults(), 16,
                                    full_cov=True)
    for rank in world:  # replicated on every rank
        mu, var = rank["predict"]
        assert np.abs(mu.reshape(-1)[:nte] - np.asarray(mu_ref)).max() < TOL
        assert np.abs(var.reshape(-1)[:nte] - np.diagonal(np.asarray(cov_ref))).max() < TOL
        assert np.all(mu.reshape(-1)[nte:] == 0) and np.all(var.reshape(-1)[nte:] == 0)
        np.testing.assert_array_equal(rank["mean_only"], mu)


def test_refusals(world):
    cholesky, predict, test_tiles = world[0]["refused"]
    assert "must divide grid" in cholesky
    assert "must divide grid" in predict
    assert "must divide process columns" in test_tiles


def test_schedule_launches():
    """Every rank runs POTRF and TRSM once a step; TRAIL only in steps where it owns a trailing tile."""
    counts = [tdist.schedule_launches(8, 2, 2, pr, pc, predict=True) for pr in (0, 1) for pc in (0, 1)]
    assert all(c["potrf"] == c["trsm"] == 8 and c["cov_tiles"] == 3 for c in counts)
    # rank (0, 1) owns rows 0, 2, 4, 6 and columns 1, 3, 5, 7: its last trailing tile (6, 5) is updated at j <= 4
    assert [c["trail"] for c in counts] == [6, 5, 6, 7]
