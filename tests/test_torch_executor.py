"""Port parity: the level-batched executor against the JAX package's.

``run_cholesky``, ``run_solve`` and the fused ``run_program`` run on CPU
tensors (the kernels' plain versions) and are held against the JAX
executor with ``backend="pallas"`` (Pallas kernels in interpret mode) on
the same numpy inputs, at the JAX package's own float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as jex
from repro.core import kernels_math as jkm
from repro.core import tiling as jtil
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import cholesky as tchol
from repro_torch.core import executor as tex
from repro_torch.core import kernels_math as tkm
from repro_torch.core import tiling as ttil
from repro_torch.core import triangular as ttri


def T(a):
    return torch.from_numpy(np.array(a))


CPU = "cpu"


def _spd(rng, n, dtype=np.float32):
    a = rng.standard_normal((n, n)).astype(dtype)
    return a @ a.T + n * np.eye(n, dtype=dtype)


@pytest.fixture(scope="module")
def program_case():
    """Padded inputs (n=40 of 48 rows, n̂=13 of 16, m=16) and the JAX env."""
    rng = np.random.default_rng(0)
    n, nt, m, d = 40, 13, 16, 2
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    xt = rng.standard_normal((nt, d)).astype(np.float32)
    xc = np.asarray(jtil.pad_features(x, m))
    yc = np.asarray(jtil.pad_vector(y, m))
    xtc = np.asarray(jtil.pad_features(xt, m))
    env = jex.run_program(
        jnp.asarray(xc), jnp.asarray(yc), jnp.asarray(xtc), jkm.SEKernelParams(1.0, 1.0, 0.1),
        n, nt, uncertainty=True, backend="pallas",
    )
    return dict(n=n, nt=nt, xc=xc, yc=yc, xtc=xtc, env={k: np.asarray(v) for k, v in env.items()})


def test_run_program_env_matches_pallas_reference(program_case):
    c = program_case
    env = tex.run_program(
        T(c["xc"]), T(c["yc"]), T(c["xtc"]), tkm.SEKernelParams(1.0, 1.0, 0.1),
        c["n"], c["nt"], uncertainty=True, device=CPU,
    )
    assert set(env) == set(c["env"])
    for name, want in c["env"].items():
        np.testing.assert_allclose(env[name].numpy(), want, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("n_streams", [None, 1, 2, 5])
def test_run_program_streams_agree(program_case, n_streams):
    c = program_case
    env = tex.run_program(
        T(c["xc"]), T(c["yc"]), T(c["xtc"]), tkm.SEKernelParams(1.0, 1.0, 0.1),
        c["n"], c["nt"], uncertainty=True, n_streams=n_streams, device=CPU,
    )
    for name in ("mean", "prior", "alpha"):
        np.testing.assert_allclose(env[name].numpy(), c["env"][name], atol=1e-3, err_msg=name)


def test_run_program_leaves_its_inputs_alone(program_case):
    c = program_case
    yc = T(c["yc"].copy())
    tex.run_program(
        T(c["xc"]), yc, T(c["xtc"]), tkm.SEKernelParams(), c["n"], c["nt"], device=CPU
    )
    np.testing.assert_array_equal(yc.numpy(), c["yc"])


@pytest.mark.parametrize("n_streams", [None, 2])
def test_run_cholesky_matches_pallas_reference(rng, n_streams):
    k = _spd(rng, 24)
    packed = np.asarray(jtil.pack_lower(jnp.asarray(k), 8))
    want = np.asarray(jex.run_cholesky(jnp.asarray(packed), n_streams=n_streams, backend="pallas"))
    got = tex.run_cholesky(T(packed), n_streams=n_streams, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    np.testing.assert_array_equal(ttil.pack_lower(T(k), 8).numpy(), packed)  # not modified


def test_cholesky_dense_via_tiles_matches_numpy_and_monolithic(rng):
    k = _spd(rng, 48)
    got = tchol.cholesky_dense_via_tiles(T(k), 16, device=CPU).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(k.astype(np.float64)), atol=1e-3)
    np.testing.assert_allclose(got, tchol.monolithic_cholesky(T(k)).numpy(), atol=1e-3)


def test_float64_factor_matches_numpy(rng):
    k = _spd(rng, 48, np.float64)
    got = tchol.cholesky_dense_via_tiles(T(k), 16, device=CPU)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(k), atol=1e-10)


def test_bf16_trailing_updates_stay_close(rng):
    k = _spd(rng, 64)
    l32 = tchol.cholesky_dense_via_tiles(T(k), 16, device=CPU).numpy()
    lmp = tchol.cholesky_dense_via_tiles(T(k), 16, update_dtype=torch.bfloat16, device=CPU).numpy()
    assert np.abs(lmp - l32).max() / np.abs(l32).max() < 0.02


@pytest.mark.parametrize("n_streams", [None, 1, 2])
def test_solves_match_dense(rng, n_streams):
    m, mt = 8, 4
    n = m * mt
    k = _spd(rng, n)
    lpacked = tchol.tiled_cholesky(ttil.pack_lower(T(k), m), device=CPU)
    l = np.linalg.cholesky(k.astype(np.float64))
    y = rng.standard_normal(n).astype(np.float32)
    yc = T(y.reshape(mt, m))
    b = ttri.forward_substitution(lpacked, yc, n_streams=n_streams, device=CPU)
    np.testing.assert_allclose(b.numpy().ravel(), np.linalg.solve(l, y), atol=1e-3)
    a = ttri.backward_substitution(lpacked, b, n_streams=n_streams, device=CPU)
    np.testing.assert_allclose(a.numpy().ravel(), np.linalg.solve(k.astype(np.float64), y), atol=1e-3)
    rhs = rng.standard_normal((n, 2 * m)).astype(np.float32)
    tiles = ttil.tile_dense(T(rhs), m).contiguous()
    v = ttri.forward_substitution_matrix(lpacked, tiles, n_streams=n_streams, device=CPU)
    np.testing.assert_allclose(ttil.untile_dense(v).numpy(), np.linalg.solve(l, rhs), atol=1e-3)
    w = ttri.backward_substitution_matrix(lpacked, tiles, n_streams=n_streams, device=CPU)
    np.testing.assert_allclose(ttil.untile_dense(w).numpy(), np.linalg.solve(l.T, rhs), atol=1e-3)
    np.testing.assert_allclose(
        ttri.packed_matvec(lpacked, a).numpy().ravel(), l @ a.numpy().ravel(), atol=1e-3
    )
    np.testing.assert_allclose(
        float(ttri.logdet_from_factor(lpacked, mt)), np.linalg.slogdet(k.astype(np.float64))[1], rtol=1e-5
    )


def test_gram_and_matvec_helpers(rng):
    v = rng.standard_normal((3, 2, 4, 4)).astype(np.float32)
    dense = ttil.untile_dense(T(v)).numpy()
    np.testing.assert_allclose(
        ttil.untile_dense(ttri.tiled_gram(T(v))).numpy(), dense.T @ dense, atol=1e-4
    )
    x = rng.standard_normal((2, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ttri.tiled_matvec(T(v), T(x)).numpy().ravel(), dense @ x.ravel(), atol=1e-4
    )


def test_logdet_masks_padding():
    lpacked = ttil.pack_lower(torch.eye(16) * 2.0, 8)
    lpacked[2, 7, 7] = 0.0  # a zero pivot past n_valid must not poison the sum
    got = float(ttri.logdet_from_factor(lpacked, 2, n_valid=12))
    np.testing.assert_allclose(got, 2 * 12 * np.log(2.0), rtol=1e-6)


def test_cuda_entry_points_raise_without_a_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    packed = ttil.pack_lower(T(_spd(rng, 16)), 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.run_cholesky(packed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tchol.tiled_cholesky(packed)
