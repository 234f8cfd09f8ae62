"""Port parity: each kernel module's plain version against the Pallas kernel.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as the
JAX package's own tests do; the port's side runs the plain PyTorch version
of each hand-written CUDA kernel, which is what its wrapper dispatches to
for a CPU tensor.  Inputs are made with numpy from a seed and handed to
both.  ``tests/test_torch_gpu.py`` holds each CUDA kernel against its plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_math as jkm
from repro.kernels import cov_assembly as jcov
from repro.kernels import lrgemm_tile as jlrg
from repro.kernels import potrf_tile as jpotrf
from repro.kernels import trailing_update as jtrail
from repro.kernels import trsm_tile as jtrsm
from repro_torch.core import kernels_math as tkm
from repro_torch.core import executor as tex
from repro_torch.kernels import cov_assembly, lrgemm_tile, ops, potrf_tile, trailing_update, trsm_tile


def T(a):
    return torch.from_numpy(np.array(a))


def _spd(rng, n, dtype=np.float32):
    a = rng.standard_normal((n, n)).astype(dtype)
    return a @ a.T + n * np.eye(n, dtype=dtype)


# ---------------------------------------------------------------------------
# cov_assembly
# ---------------------------------------------------------------------------


def _cov_case(rng, t, m, mb, d):
    xa = rng.standard_normal((t, m, d)).astype(np.float32)
    xb = rng.standard_normal((t, mb, d)).astype(np.float32)
    row0 = (rng.integers(0, 3, t) * m).astype(np.int32)
    col0 = (rng.integers(0, 3, t) * mb).astype(np.int32)
    return xa, xb, row0, col0


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("m,mb,d", [(8, 8, 1), (16, 16, 3), (16, 8, 2)])
def test_cov_tiles_plain_matches_pallas(rng, symmetric, m, mb, d):
    t = 5
    xa, xb, row0, col0 = _cov_case(rng, t, m, mb, d)
    nvr = rng.integers(m, 3 * m, t).astype(np.int32)  # ragged, per tile
    nvc = rng.integers(mb, 3 * mb, t).astype(np.int32)
    jp = jkm.SEKernelParams(1.3, 0.8, 0.05)
    want = jcov.cov_tiles(
        jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(row0), jnp.asarray(col0),
        kernel=jkm.SQUARED_EXPONENTIAL, params=jp, n_valid_r=jnp.asarray(nvr),
        n_valid_c=jnp.asarray(nvc), symmetric=symmetric, interpret=True,
    )
    tp = tkm.SEKernelParams(1.3, 0.8, 0.05)
    got = ops.cov_tiles(
        T(xa), T(xb), T(row0), T(col0), T(nvr), T(nvc), tp, symmetric=symmetric
    )
    assert got.shape == (t, m, mb) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    # the masks agree exactly: zeros, ones and pinned diagonals in the same places
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_cov_tiles_diagonal_bitwise_at_offset():
    """Offset-256 data: the global diagonal is the float32 constant v + sigma^2."""
    rng = np.random.default_rng(0)
    m, n = 32, 64
    x = (256.0 + 10.0 * rng.random((n, 2))).astype(np.float32)
    xc = x.reshape(2, m, 2)
    rows, cols = np.array([0, 1, 1]), np.array([0, 0, 1])
    jp = jkm.SEKernelParams(1.0, 1.0, 0.1)
    want = np.asarray(
        jcov.cov_tiles(
            jnp.asarray(xc[rows]), jnp.asarray(xc[cols]), jnp.asarray(rows * m),
            jnp.asarray(cols * m), kernel=jkm.SQUARED_EXPONENTIAL, params=jp,
            n_valid_r=n, n_valid_c=n, symmetric=True, interpret=True,
        )
    )
    got = ops.cov_tiles(
        T(xc[rows]), T(xc[cols]), T(rows * m), T(cols * m), n, n,
        tkm.SEKernelParams(1.0, 1.0, 0.1), symmetric=True,
    ).numpy()
    for tile in (0, 2):
        assert np.all(np.diagonal(got[tile]) == np.float32(1.1))
        np.testing.assert_array_equal(np.diagonal(got[tile]), np.diagonal(want[tile]))
    # off the diagonal both sides use the expanded distance form, which
    # cancels at this offset (|x|^2 ~ 1.3e5): they agree only to its rounding
    np.testing.assert_allclose(got, want, atol=0.05)


# ---------------------------------------------------------------------------
# lrgemm (the low-rank tier's tile matvecs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g,m,mb", [(5, 16, 16), (3, 16, 8), (7, 8, 24)])
def test_lrgemm_plain_matches_pallas(rng, g, m, mb):
    """A pre-gathered (G, m, mb) stack, m = mb and m != mb; float32 at 1e-5."""
    a = rng.standard_normal((g, m, mb)).astype(np.float32)
    v = rng.standard_normal((g, mb)).astype(np.float32)
    want = np.asarray(jlrg.lrgemm_tiles(jnp.asarray(a), jnp.asarray(v), interpret=True))
    idx = torch.arange(g)
    got = ops.lrgemm(T(a), T(v), idx, idx)
    assert got.shape == (g, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("mu_tiles,n_tiles,mb", [(2, 3, 16), (3, 2, 8)])
def test_lrgemm_plain_with_plan_indices_matches_pallas(rng, mu_tiles, n_tiles, mb):
    """The flat K_un grid read through ``lowrank_plan``'s index vectors,
    against the Pallas kernel on the gathered stacks (1e-5)."""
    m = 16
    kflat = rng.standard_normal((mu_tiles * n_tiles, m, mb)).astype(np.float32)
    v = rng.standard_normal((n_tiles, mb)).astype(np.float32)
    (bt,), = tex.lowrank_plan(mu_tiles, n_tiles).levels
    want = np.asarray(
        jlrg.lrgemm_tiles(jnp.asarray(kflat[bt.a]), jnp.asarray(v[bt.b]), interpret=True)
    )
    got = lrgemm_tile.lrgemm_plain(T(kflat), T(v), T(bt.a), T(bt.b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_lrgemm_plain_float64_matches_numpy(rng):
    """float64 stays float64 (the Pallas body would drop to float32): 1e-12."""
    kflat = rng.standard_normal((6, 16, 12))
    v = rng.standard_normal((3, 12))
    a, b = np.array([5, 0, 2, 2]), np.array([1, 2, 0, 1])
    got = lrgemm_tile.lrgemm_plain(T(kflat), T(v), T(a), T(b))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.einsum("gab,gb->ga", kflat[a], v[b]), atol=1e-12)


def test_lrgemm_cuda_refuses_what_it_does_not_take(rng):
    k = T(rng.standard_normal((2, 8, 8)).astype(np.float32))
    v = T(rng.standard_normal((2, 8)).astype(np.float32))
    idx = torch.arange(2)
    with pytest.raises(ValueError):  # CPU tensors
        lrgemm_tile.lrgemm_cuda(k, v, idx, idx)
    with pytest.raises(TypeError):
        lrgemm_tile.lrgemm_cuda(k, v.double(), idx, idx)
    with pytest.raises(TypeError):
        lrgemm_tile.lrgemm_cuda(k, v, idx.int(), idx)


# ---------------------------------------------------------------------------
# potrf / trsm / trailing update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [8, 16])
def test_potrf_plain_matches_pallas(rng, m):
    k = np.stack([_spd(rng, m) for _ in range(3)])
    got = ops.potrf(T(k)).numpy()
    for g in range(3):
        want = np.asarray(jpotrf.potrf(jnp.asarray(k[g]), interpret=True))
        np.testing.assert_allclose(got[g], want, atol=1e-4 * m)
    assert np.all(np.triu(got, 1) == 0)


def test_potrf_plain_float64_matches_numpy(rng):
    k = np.stack([_spd(rng, 16, np.float64) for _ in range(2)])
    got = potrf_tile.potrf_plain(T(k))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(k), atol=1e-10)


def test_potrf_plain_nonpositive_pivot_gives_nan():
    a = torch.eye(4).unsqueeze(0).clone()
    a[0, 2, 2] = -1.0
    assert torch.isnan(ops.potrf(a)[0, 2, 2])


@pytest.mark.parametrize("m", [8, 16])
def test_trsm_plain_matches_pallas_with_per_task_l(rng, m):
    g = 3
    l = np.stack([np.linalg.cholesky(_spd(rng, m)).astype(np.float32) for _ in range(g)])
    b = rng.standard_normal((g, m, m)).astype(np.float32)
    got = ops.trsm(T(l), T(b)).numpy()
    for i in range(g):  # a different L_JJ for every task, as the executor passes
        want = np.asarray(jtrsm.trsm(jnp.asarray(l[i]), jnp.asarray(b[i]), interpret=True))
        np.testing.assert_allclose(got[i], want, atol=1e-3)
    np.testing.assert_allclose(
        np.einsum("gij,gkj->gik", got, l), b, atol=1e-3
    )


@pytest.mark.parametrize("m", [8, 16])
def test_trail_plain_matches_pallas(rng, m):
    g = 4
    c, a, b = (rng.standard_normal((g, m, m)).astype(np.float32) for _ in range(3))
    want = np.asarray(
        jtrail.trailing_update(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), block=m, interpret=True)
    )
    got = ops.trail(T(c), T(a), T(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    # SYRK tasks hand the same panel tile in as A and B
    np.testing.assert_allclose(
        ops.trail(T(c), T(a), T(a)).numpy(),
        np.asarray(jtrail.trailing_update(jnp.asarray(c), jnp.asarray(a), jnp.asarray(a), block=m, interpret=True)),
        atol=1e-3,
    )


def test_trail_plain_bf16_operands_match_pallas(rng):
    g, m = 3, 16
    c, a, b = (rng.standard_normal((g, m, m)).astype(np.float32) for _ in range(3))
    bf = jnp.bfloat16
    want = np.asarray(
        jtrail.trailing_update(
            jnp.asarray(c), jnp.asarray(a, bf), jnp.asarray(b, bf), block=m, interpret=True
        ),
        np.float32,
    )
    got = ops.trail(T(c), T(a), T(b), torch.bfloat16)
    assert got.dtype == torch.float32  # only the operands are cast
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 0.02


def test_trail_variant_rule():
    """Big tiles from half the H100's SMs' worth of them (128 x 128; 64 x 64 for float64), 16-byte loads
    when a row is whole vectors; the gpu tests' grid reaches every (tile, load width) pair."""
    f32, bf, f64 = torch.float32, torch.bfloat16, torch.float64
    v = trailing_update.trail_variant
    assert v(496, 512, f32) == (True, True) and v(8, 512, f32) == (True, True)
    assert v(4, 512, f32) == (False, True) and v(1, 512, bf) == (False, True)
    assert v(40, 129, f32) == (True, False) and v(3, 100, bf) == (False, False) and v(3, 100, f32) == (False, True)
    assert v(17, 512, f64) == (True, True) and v(1, 512, f64) == (False, True)
    grid = [(g, m) for g in (1, 3, 40) for m in (16, 77, 100, 128, 129, 512)]
    for dt in (f32, bf, f64):
        assert {v(g, m, dt) for g, m in grid} == {(True, True), (True, False), (False, True), (False, False)}


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(rng):
    ops.reset_launch_counts()
    k = T(_spd(rng, 8)[None])
    ops.potrf(k)
    ops.trsm(k, k)
    ops.trail(k, k, k)
    x = T(rng.standard_normal((1, 8, 2)).astype(np.float32))
    ops.cov_tiles(x, x, 0, 0, 8, 8, tkm.SEKernelParams(), symmetric=True)
    ops.carry_update(k, k, k, k)
    ops.lrgemm(k, k[0], torch.zeros(3, dtype=torch.int64), torch.arange(3))
    qkv = T(rng.standard_normal((1, 4, 2, 16)).astype(np.float32))
    ops.flash_attention(qkv, qkv, qkv, softcap=5.0, window=2)
    ops.tile_gemv(k[:, None, None], k[:, None, None, 0])
    ops.tile_trsv(k[:, None], k[:, None, 0], True)
    assert ops.launch_counts() == {
        "cov_tiles": 0, "potrf": 0, "trsm": 0, "trail": 0, "carry_update": 0, "lrgemm": 0,
        "flash_attention": 0, "tile_gemv": 0, "tile_trsv": 0,
    }


def test_cuda_launchers_refuse_cpu_tensors(rng):
    k = T(_spd(rng, 8)[None])
    with pytest.raises(ValueError):
        potrf_tile.potrf_cuda(k)
    with pytest.raises(ValueError):
        trsm_tile.trsm_cuda(k, k)
    with pytest.raises(ValueError):
        trailing_update.trail_cuda(k, k, k)
    x = T(rng.standard_normal((1, 8, 2)).astype(np.float32))
    with pytest.raises(ValueError):
        cov_assembly.cov_tiles_cuda(x, x, 0, 0, 8, 8, tkm.SEKernelParams(), symmetric=True)
