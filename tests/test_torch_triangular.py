"""``identity_tiles`` and ``kinv_tiles_from_factor`` of the port against ``repro.core.triangular``.

The factor of an SPD matrix whose n is not a multiple of the tile (padded
with an identity block, as the assembly pads it) goes through both packages
as one packed store, single and problem-batched, in float32 and float64.
Tolerances are ``tests/test_triangular.py``'s: the tiled matrix solve at
atol 1e-3 in float32 (on the matrix solve and gram, both packages take the
same ops); float64 at 1e-10.  Each result is also held to the dense inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import triangular as jtri
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import tiling, triangular

N, M = 50, 16  # padded to 64: four tile rows, the last one part padding
TOL = {np.float32: 1e-3, np.float64: 1e-10}


def _packed_factor(rng, n, m, dtype):
    """(packed identity-padded Cholesky factor (T, m, m), dense K (n, n))."""
    a = rng.standard_normal((n, n))
    k = a @ a.T + n * np.eye(n)
    n_pad = -(-n // m) * m
    l_pad = np.eye(n_pad)
    l_pad[:n, :n] = np.linalg.cholesky(k)
    m_tiles = n_pad // m
    rows, cols = tiling._packed_coords(m_tiles)
    tiles = l_pad.reshape(m_tiles, m, m_tiles, m).transpose(0, 2, 1, 3)
    return tiles[rows, cols].astype(dtype), k


def _jax_x64(dtype):
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _x64_off():
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_identity_tiles_match_reference(dtype):
    _jax_x64(dtype)
    got = triangular.identity_tiles(3, 4, getattr(torch, np.dtype(dtype).name), device="cpu")
    want = np.asarray(jtri.identity_tiles(3, 4, jnp.dtype(dtype)))
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.permute(0, 2, 1, 3).reshape(12, 12).numpy(), np.eye(12))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kinv_single_factor_matches_reference(dtype):
    _jax_x64(dtype)
    lp, k = _packed_factor(np.random.default_rng(0), N, M, dtype)
    got = triangular.kinv_tiles_from_factor(torch.from_numpy(lp), device="cpu")
    want = np.asarray(jtri.kinv_tiles_from_factor(jnp.asarray(lp)))
    assert got.shape == want.shape == (4, 4, M, M) and got.dtype == torch.from_numpy(lp).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    dense = tiling.untile_dense(got).numpy()
    np.testing.assert_allclose(dense[:N, :N], np.linalg.inv(k), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(dense[N:, N:], np.eye(64 - N), rtol=0, atol=TOL[dtype])  # the padded block
    np.testing.assert_allclose(dense[:N, N:], 0.0, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kinv_batched_factor_matches_reference_and_each_problem(dtype):
    _jax_x64(dtype)
    rng = np.random.default_rng(1)
    lps, ks = zip(*(_packed_factor(rng, N, M, dtype) for _ in range(3)))
    lp = np.stack(lps)
    got = triangular.kinv_tiles_from_factor(torch.from_numpy(lp), device="cpu")
    want = np.asarray(jtri.kinv_tiles_from_factor(jnp.asarray(lp)))
    assert got.shape == want.shape == (3, 4, 4, M, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    for i, k in enumerate(ks):
        single = triangular.kinv_tiles_from_factor(torch.from_numpy(lps[i]), device="cpu")
        np.testing.assert_allclose(got[i].numpy(), single.numpy(), rtol=0, atol=TOL[dtype])
        np.testing.assert_allclose(tiling.untile_dense(got[i]).numpy()[:N, :N], np.linalg.inv(k), rtol=0,
                                   atol=TOL[dtype])


def test_kinv_device_defaults_to_the_factors_and_cuda_raises_without_a_card():
    lp, _ = _packed_factor(np.random.default_rng(2), N, M, np.float32)
    assert triangular.kinv_tiles_from_factor(torch.from_numpy(lp)).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            triangular.identity_tiles(2, 4)
