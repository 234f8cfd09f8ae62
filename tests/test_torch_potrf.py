"""The blocked POTRF kernel's algorithm, on the CPU.

``csrc/potrf_tile.cu`` runs each tile's blocked Cholesky DAG in one launch:
one CTA per lower ``nb x nb`` block, handed out by a ticket counter (tile by
tile, then column-major through the lower triangle), each CTA left-looking:
C = A_ij - sum_k L_ik L_jk^T, then a factorization (i == j) or a solve
against L_jj (i > j).  CUDA cannot run here, so this file holds

* a mirror of the kernel's ticket -> (g, i, j) map and workspace offsets,
  and checks that every block waits only on lower tickets (the kernel's
  argument against deadlock);
* a plain PyTorch rendition of the kernel's arithmetic, walked in ticket
  order, held against the Pallas ``potrf`` (interpret mode, as the JAX
  package's tests run it on the CPU) and numpy, at ragged m and with NaN at
  a failing pivot.

``tests/test_torch_gpu.py`` holds the kernel itself against ``potrf_plain``
on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import potrf_tile as jpotrf
from repro_torch.kernels import potrf_tile

CU_SOURCE = Path(potrf_tile.__file__).resolve().parent / "csrc" / "potrf_tile.cu"


def ticket_block(ticket, t_rows):
    """(g, i, j) of a ticket, as the kernel's thread 0 maps it."""
    per_tile = t_rows * (t_rows + 1) // 2
    g, r = divmod(ticket, per_tile)
    j = 0
    while r >= t_rows - j:
        r -= t_rows - j
        j += 1
    return g, j + r, j


def block_offset(i, j, t_rows):
    """Index of lower block (i, j) in a tile's packed workspace (``block_offset``)."""
    return j * t_rows - j * (j - 1) // 2 + (i - j)


def dependencies(i, j):
    """The blocks CTA (i, j) waits on: (i, k) and (j, k) for k < j, and (j, j) if i > j."""
    deps = {(i, k) for k in range(j)} | {(j, k) for k in range(j)}
    if i > j:
        deps.add((j, j))
    return deps


def test_kernel_block_edge_is_the_wrappers():
    nb = re.search(r"constexpr int NB = (\d+);", CU_SOURCE.read_text())
    assert nb is not None and int(nb.group(1)) == potrf_tile.BLOCK


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("m", [1, 31, 32, 33, 40, 100, 512, 1024])
def test_tickets_wait_only_on_lower_tickets(m, nb, n_tiles):
    t_rows = -(-m // nb)
    per_tile = t_rows * (t_rows + 1) // 2
    blocks = [ticket_block(t, t_rows) for t in range(n_tiles * per_tile)]
    lower = {(g, i, j) for g in range(n_tiles) for j in range(t_rows) for i in range(j, t_rows)}
    assert len(blocks) == len(set(blocks)) and set(blocks) == lower  # each block once
    ticket_of = {b: t for t, b in enumerate(blocks)}
    for t, (g, i, j) in enumerate(blocks):
        assert t % per_tile == block_offset(i, j, t_rows)  # workspace order = ticket order
        for di, dj in dependencies(i, j):
            assert ticket_of[(g, di, dj)] < t


def _factor_rows(c):
    """The diagonal CTA's warp: lane r holds row r; right-looking, column c broadcast."""
    x = c.clone()
    nb = x.shape[0]
    lane = torch.arange(nb)
    for k in range(nb):
        col = x[:, k].clone()
        rs = torch.rsqrt(col[k])
        l = x[:, k] * rs
        s = l * rs
        x[:, k + 1 :] -= s[:, None] * col[None, k + 1 :]
        d = col[k] * rs
        x[:, k] = torch.where(lane > k, l, torch.where(lane == k, d, torch.zeros_like(d)))
    return x


def _solve_rows(c, l):
    """An off-diagonal CTA's warp: X L^T = C, lane r solves row r."""
    x = c.clone()
    inv = 1 / torch.diagonal(l)
    for k in range(x.shape[0]):
        x[:, k] *= inv[k]
        x[:, k + 1 :] -= x[:, k : k + 1] * l[None, k + 1 :, k]
    return x


def blocked_potrf(a, nb):
    """The kernel's algorithm on a (G, m, m) stack, walked in ticket order."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    g_tiles, m = a.shape[0], a.shape[-1]
    t_rows = -(-m // nb)
    mp = t_rows * nb
    padded = torch.zeros(g_tiles, mp, mp, dtype=a.dtype)
    padded[:, :m, :m] = a
    pad = torch.arange(m, mp)
    padded[:, pad, pad] = 1  # the diagonal block's pad is the identity
    done = {}
    for t in range(g_tiles * t_rows * (t_rows + 1) // 2):
        g, i, j = ticket_block(t, t_rows)
        c = padded[g, i * nb : (i + 1) * nb, j * nb : (j + 1) * nb].clone()
        for k in range(j):
            c -= done[g, i, k] @ done[g, j, k].T
        done[g, i, j] = _factor_rows(c) if i == j else _solve_rows(c, done[g, j, j])
    out = torch.zeros(g_tiles, mp, mp, dtype=a.dtype)
    for (g, i, j), blk in done.items():
        out[g, i * nb : (i + 1) * nb, j * nb : (j + 1) * nb] = blk
    return out[:, :m, :m]


def _spd_stack(rng, g, m, dtype):
    r = rng.standard_normal((g, m, m))
    return (r @ r.transpose(0, 2, 1) / m + np.eye(m)).astype(dtype)


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("m", [1, 31, 33, 40, 64, 77, 100])
def test_blocked_float32_matches_pallas_and_numpy(rng, m, nb):
    a = _spd_stack(rng, 2, m, np.float32)
    got = blocked_potrf(torch.from_numpy(a), nb)
    assert got.dtype == torch.float32
    tol = 1e-4 * m
    for g in range(2):
        want = np.asarray(jpotrf.potrf(jnp.asarray(a[g]), interpret=True))
        np.testing.assert_allclose(got[g].numpy(), want, atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(a.astype(np.float64)), atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), potrf_tile.potrf_plain(torch.from_numpy(a)).numpy(),
                               atol=tol, rtol=0)
    assert torch.all(torch.triu(got, 1) == 0)


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("m", [1, 31, 33, 40, 64, 77, 100])
def test_blocked_float64_matches_numpy(rng, m, nb):
    a = _spd_stack(rng, 2, m, np.float64)
    got = blocked_potrf(torch.from_numpy(a), nb)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(a), atol=1e-10 * m, rtol=0)
    np.testing.assert_allclose(got.numpy(), potrf_tile.potrf_plain(torch.from_numpy(a)).numpy(),
                               atol=1e-10 * m, rtol=0)


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("m,pivot", [(40, 5), (40, 35), (77, 70), (100, 64), (100, 99)])
def test_blocked_nonpositive_pivot_gives_nan_as_pallas(rng, m, pivot, nb):
    a = _spd_stack(rng, 1, m, np.float32)
    a[0, pivot, pivot] = -1.0  # the Schur complement at pivot is negative
    got = blocked_potrf(torch.from_numpy(a), nb)[0]
    want = np.asarray(jpotrf.potrf(jnp.asarray(a[0]), interpret=True))
    plain = potrf_tile.potrf_plain(torch.from_numpy(a))[0]
    nan = torch.isnan(got).numpy()
    assert nan[pivot, pivot] and np.isnan(want[pivot, pivot])
    # NaN fills the trailing lower triangle from the pivot on, as in the plain
    # loop; the Pallas loop's masked rank-1 update (0 * NaN) also spreads it to
    # the earlier columns of the rows below the pivot
    np.testing.assert_array_equal(nan, torch.isnan(plain).numpy())
    assert np.all(np.isnan(want)[nan])
    assert np.all(nan[pivot:, pivot:] == np.tril(np.ones((m - pivot, m - pivot), bool)))
    np.testing.assert_allclose(got[:pivot].numpy(), want[:pivot], atol=1e-4 * m, rtol=0)
