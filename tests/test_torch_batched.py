"""Port parity: the problem-batched fleet (``GPBatch``) against the JAX package.

B = 3 problems of n = 40 points in D = 2, tile 16, 9 test points each, the
sizes of ``tests/test_batched.py``.  Inputs are made with numpy from a seed
and handed to both packages; the port runs on CPU tensors (the kernels'
plain versions), the reference with ``op_backend="jnp"``, its own route for
per-problem hyperparameters.  Each JAX result is computed once, in a
module-scoped fixture, and shared by the cases that read it.  Tolerances:
float32 means and variances within 1e-4 of the reference (the port and
the reference sum the same float32 tile products in another order; values
are O(1)), NLMLs within 1e-4 relative, Adam trajectories within 1e-4,
gradients within 1e-3 relative per component; float64 against a numpy
dense solve within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as jgp
from repro.core import kernels_math as jkm
from repro.core import mll as jmll
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import convert
from repro_torch.core import GaussianProcess, GPBatch, SEKernelParams
from repro_torch.core import executor as tex
from repro_torch.core import kernels_math as tkm
from repro_torch.core import mll as tmll
from repro_torch.core import predict as tpred
from repro_torch.kernels import ops

CPU = "cpu"
B, N, NT, D, M = 3, 40, 9, 2, 16
LS = np.asarray([0.7, 1.0, 1.6], np.float32)
NOISE = np.asarray([0.05, 0.1, 0.2], np.float32)
KINDS = ("shared", "per_problem")


def _data(seed=0, b=B, n=N, nt=NT, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, D)).astype(dtype)
    y = (np.sin(x.sum(-1)) + 0.1 * rng.standard_normal((b, n))).astype(dtype)
    xt = rng.standard_normal((b, nt, D)).astype(dtype)
    return x, y, xt


def _params(kind):
    """(port params, JAX params) of one kind: shared floats, or per-problem (B,) leaves."""
    if kind == "shared":
        return SEKernelParams(0.9, 1.1, 0.1), jkm.SEKernelParams(0.9, 1.1, 0.1)
    return (SEKernelParams(torch.from_numpy(LS), 1.1, torch.from_numpy(NOISE)),
            jkm.SEKernelParams(jnp.asarray(LS), 1.1, jnp.asarray(NOISE)))


def _close(got, want, tol, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), 1.0) if rel else 1.0
    assert np.all(np.abs(got - want) <= tol * scale), float(np.max(np.abs(got - want) / scale))


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference result of this file, computed once."""
    x, y, xt = _data()
    x2, y2, _ = _data(seed=1, n=32)
    out = {}
    for kind in KINDS:
        _, pj = _params(kind)
        fleet = jgp.GPBatch(x, y, params=pj, tile_size=M)
        mean, cov = fleet.predict_full_cov(xt)
        out[kind] = dict(mean=np.asarray(mean), cov=np.asarray(cov), nlml=np.asarray(fleet.nlml()))
        low = jgp.GPBatch(x, y, params=pj, tile_size=M, method="lowrank", m_inducing=16)
        lm, lv = low.predict_with_uncertainty(xt)
        out[kind]["lowrank"] = (np.asarray(lm), np.asarray(lv))
    out["state"] = fleet.posterior()  # the per-problem fleet's stacked state, warm from its cold call
    _, pj = _params("per_problem")
    fleet = jgp.GPBatch(x, y, params=pj, tile_size=M)
    fleet.predict(xt)
    fleet.update(x2[:, :8], y2[:, :8])  # refills the partial trailing tile-row: one append step
    up = np.asarray(fleet.predict(xt))
    fleet.forget(16)
    out["update_forget"] = (up, np.asarray(fleet.predict(xt)))
    trained, curves = jmll.optimize_hyperparameters_batched(x, y, pj, steps=3, lr=0.05, tile_size=M)
    out["optimize"] = [np.asarray(l) for l in jax.tree_util.tree_leaves(trained)]
    out["curves"] = np.asarray(curves)
    p_full = jkm.SEKernelParams(jnp.asarray(LS), jnp.full((B,), 1.1, jnp.float32), jnp.asarray(NOISE))
    val, grads = jax.value_and_grad(
        lambda p, xx, yy: jnp.sum(jmll.nlml_tiled_batched(xx, yy, p, tile_size=M)), argnums=(0, 1, 2)
    )(p_full, jnp.asarray(x), jnp.asarray(y))
    out["grad"] = (float(val), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads[0])],
                   np.asarray(grads[1]), np.asarray(grads[2]))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_predict_full_cov_matches_jax(ref, kind):
    x, y, xt = _data()
    fleet = GPBatch(x, y, params=_params(kind)[0], tile_size=M, device=CPU)
    mean, cov = fleet.predict_full_cov(xt)
    _close(mean.numpy(), ref[kind]["mean"], 1e-4)
    _close(cov.numpy(), ref[kind]["cov"], 1e-4)
    assert fleet._cache_warm()


@pytest.mark.parametrize("kind", KINDS)
def test_warm_predict_with_uncertainty_matches_cold(ref, kind):
    x, y, xt = _data()
    fleet = GPBatch(x, y, params=_params(kind)[0], tile_size=M, device=CPU)
    cold = fleet.predict(xt)
    mean, var = fleet.predict_with_uncertainty(xt)  # warm: the batched tail off the cached factors
    _close(mean.numpy(), cold.numpy(), 1e-5)
    _close(var.numpy(), np.diagonal(ref[kind]["cov"], axis1=-2, axis2=-1), 1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_nlml_matches_jax(ref, kind):
    x, y, _ = _data()
    fleet = GPBatch(x, y, params=_params(kind)[0], tile_size=M, device=CPU)
    _close(fleet.nlml().numpy(), ref[kind]["nlml"], 1e-4, rel=True)
    _close(fleet.log_marginal_likelihood().numpy(), -ref[kind]["nlml"], 1e-4, rel=True)


@pytest.mark.parametrize("kind", KINDS)
def test_batch_equals_a_loop_of_single_gps(kind):
    """Each problem of the batch predicts as its own GaussianProcess: the mean bitwise (the same plain
    tiles), the variance within 1e-6 (the batched triangular solves of the uncertainty tail)."""
    x, y, xt = _data()
    pt, _ = _params(kind)
    mean, var = GPBatch(x, y, params=pt, tile_size=M, device=CPU).predict_with_uncertainty(xt)
    for i in range(B):
        gp = GaussianProcess(x[i], y[i], params=tkm.gather_params(pt, i), tile_size=M, device=CPU)
        mi, vi = gp.predict_with_uncertainty(xt[i])
        torch.testing.assert_close(mean[i], mi, rtol=0, atol=0)
        torch.testing.assert_close(var[i], vi, rtol=0, atol=1e-6)


def test_vmap_dispatch_equals_flat():
    x, y, xt = _data()
    pt, _ = _params("per_problem")
    flat = GPBatch(x, y, params=pt, tile_size=M, device=CPU).predict_full_cov(xt)
    per = GPBatch(x, y, params=pt, tile_size=M, batch_dispatch="vmap", device=CPU).predict_full_cov(xt)
    for a, b in zip(flat, per):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="batch_dispatch"):
        GPBatch(x, y, tile_size=M, batch_dispatch="scan", device=CPU)
    with pytest.raises(ValueError, match="batch_dispatch"):
        tex._tile_dispatch(ops.potrf, True, "scan")


def test_params_written_in_place_rebuild_the_posterior():
    """A tensor leaf written in place moves the cache key: the next call rebuilds with the new values."""
    x, y, xt = _data()
    fleet = GPBatch(x, y, params=SEKernelParams(torch.from_numpy(LS.copy()), 1.1, torch.from_numpy(NOISE.copy())),
                    tile_size=M, device=CPU)
    before = fleet.predict(xt)
    assert fleet._cache_warm()
    fleet.params.lengthscale.mul_(2.0)
    assert not fleet._cache_warm()
    after = fleet.predict(xt)
    cold = GPBatch(x, y, params=SEKernelParams(torch.from_numpy(2 * LS), 1.1, torch.from_numpy(NOISE)),
                   tile_size=M, device=CPU).predict(xt)
    torch.testing.assert_close(after, cold, rtol=0, atol=0)
    assert not torch.equal(before, after) and fleet._cache_warm()


def test_update_and_forget_match_jax_and_stay_warm(ref):
    x, y, xt = _data()
    x2, y2, _ = _data(seed=1, n=32)
    fleet = GPBatch(x, y, params=_params("per_problem")[0], tile_size=M, device=CPU)
    fleet.predict(xt)
    ops.reset_launch_counts()
    fleet.update(x2[:, :8], y2[:, :8])
    assert fleet._cache_warm() and fleet.x_train.shape == (B, N + 8, D)
    up = fleet.predict(xt)
    _close(up.numpy(), ref["update_forget"][0], 1e-4)
    fleet.forget(16)
    assert fleet._cache_warm()
    _close(fleet.predict(xt).numpy(), ref["update_forget"][1], 1e-4)
    cold = GPBatch(fleet.x_train, fleet.y_train, params=fleet.params, tile_size=M, device=CPU)
    _close(fleet.predict(xt).numpy(), cold.predict(xt).numpy(), 1e-4)
    assert all(v == 0 for v in ops.launch_counts().values())  # the CPU path launches nothing
    fleet.forget(5)  # unaligned: refactorizes on the next call
    assert not fleet._cache_warm()
    with pytest.raises(ValueError, match="stacked"):
        fleet.update(x2[:2], y2[:2])


def test_optimize_matches_jax(ref):
    x, y, _ = _data()
    fleet = GPBatch(x, y, params=_params("per_problem")[0], tile_size=M, device=CPU).optimize(steps=3, lr=0.05)
    got = [fleet.params.lengthscale, fleet.params.vertical, fleet.params.noise]
    for g, w in zip(got, ref["optimize"]):
        assert g.shape == (B,)
        _close(g.numpy(), w, 1e-4)
    _, curves = tmll.optimize_hyperparameters_batched(x, y, _params("per_problem")[0], steps=3, lr=0.05,
                                                      tile_size=M, device=CPU)
    assert curves.shape == (3, B)
    _close(curves.numpy(), ref["curves"], 1e-4, rel=True)


@pytest.mark.parametrize("vjp", ["custom", "autodiff"])
def test_nlml_tiled_batched_gradient_matches_jax(ref, vjp):
    """Both of the port's reverse modes against the reference's blocked rule (the same gradient)."""
    x, y, _ = _data()
    leaves = [torch.tensor(np.asarray(v), requires_grad=True) for v in (LS, np.full(B, 1.1, np.float32), NOISE)]
    xt_, yt_ = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    val = tmll.nlml_tiled_batched(xt_, yt_, SEKernelParams(*leaves), tile_size=M, vjp=vjp, device=CPU)
    assert val.shape == (B,)
    grads = torch.autograd.grad(val.sum(), leaves + [xt_, yt_])
    want_val, want_p, want_x, want_y = ref["grad"]
    _close(float(val.detach().sum()), want_val, 1e-4, rel=True)
    for g, w in zip(grads[:3], want_p):
        _close(g.numpy(), w, 1e-3, rel=True)
    _close(grads[3].numpy(), want_x, 1e-3, rel=True)
    _close(grads[4].numpy(), want_y, 1e-3, rel=True)


@pytest.mark.parametrize("kind", KINDS)
def test_lowrank_batch_matches_jax(ref, kind):
    x, y, xt = _data()
    fleet = GPBatch(x, y, params=_params(kind)[0], tile_size=M, method="lowrank", m_inducing=16, device=CPU)
    mean, var = fleet.predict_with_uncertainty(xt)
    _close(mean.numpy(), ref[kind]["lowrank"][0], 2e-3)
    _close(var.numpy(), ref[kind]["lowrank"][1], 2e-3)
    assert fleet.nlml().shape == (B,)


def test_lowrank_batch_update_forget_match_cold():
    x, y, xt = _data()
    x2, y2, _ = _data(seed=1, n=32)
    pt, _ = _params("per_problem")
    u = x[:, :16]
    fleet = GPBatch(x, y, params=pt, tile_size=M, method="lowrank", m_inducing=16, inducing=u, device=CPU)
    fleet.predict(xt)
    fleet.update(x2[:, :7], y2[:, :7]).forget(5)
    assert fleet._lowrank_warm()
    cold = GPBatch(fleet.x_train, fleet.y_train, params=pt, tile_size=M, method="lowrank", m_inducing=16,
                   inducing=u, device=CPU)
    _close(fleet.predict(xt).numpy(), cold.predict(xt).numpy(), 2e-3)


def test_stacked_state_carried_over_from_jax_predicts_the_same(ref):
    """A JAX GPBatch's stacked posterior, with (B,) leaves, crosses over through convert.py and predicts warm."""
    st = ref["state"]
    xt = _data()[2]
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(st.params)]
    params = convert.kernel_params_from_numpy("se", leaves)
    assert params.lengthscale.shape == (B,)
    state = convert.posterior_state_from_numpy(
        st.lpacked, st.alpha, st.x_chunks, st.n, st.m, params, st.beta, st.y_chunks, device=CPU
    )
    mean, cov = tpred.predict_from_state_batched(state, torch.from_numpy(xt), full_cov=True)
    _close(mean.numpy(), ref["per_problem"]["mean"], 1e-4)
    _close(cov.numpy(), ref["per_problem"]["cov"], 1e-4)


def test_float64_batch_matches_numpy_dense():
    x, y, xt = _data(dtype=np.float64)
    pt = SEKernelParams(torch.tensor(LS, dtype=torch.float64), 1.1, torch.tensor(NOISE, dtype=torch.float64))
    mean, var = GPBatch(x, y, params=pt, tile_size=M, dtype=torch.float64, device=CPU).predict_with_uncertainty(xt)
    assert mean.dtype == torch.float64
    for i in range(B):
        l, nz = float(LS[i]), float(NOISE[i])

        def k(a, b):
            return 1.1 * np.exp(-0.5 / l * ((a[:, None] - b[None]) ** 2).sum(-1))

        kxx = k(x[i], x[i]) + nz * np.eye(N)
        ks = k(xt[i], x[i])
        np.testing.assert_allclose(mean[i].numpy(), ks @ np.linalg.solve(kxx, y[i]), rtol=0, atol=1e-9)
        np.testing.assert_allclose(var[i].numpy(), 1.1 - np.einsum("ij,ji->i", ks, np.linalg.solve(kxx, ks.T)),
                                   rtol=0, atol=1e-9)


def test_validation_and_shared_test_points():
    x, y, xt = _data()
    with pytest.raises(ValueError, match="stacked"):
        GPBatch(x[0], y, device=CPU)
    with pytest.raises(ValueError, match="per-problem"):
        GPBatch(x, y, params=SEKernelParams(torch.ones(2), 1.0, 0.1), device=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        GPBatch(x, y, mesh=object(), device=CPU)
    fleet = GPBatch(x, y, tile_size=M, device=CPU)
    shared = fleet.predict(xt[0])
    stacked = fleet.predict(np.broadcast_to(xt[0], (B,) + xt[0].shape).copy())
    torch.testing.assert_close(shared, stacked, rtol=0, atol=0)
    with pytest.raises(ValueError, match="x_test"):
        fleet.predict(np.zeros((B + 1, 4, D), np.float32))
    one_d = GPBatch(x[..., 0], y, tile_size=M, device=CPU)
    assert one_d.predict(xt[..., 0]).shape == (B, NT)


@pytest.mark.parametrize("kind", ["shared", "per_problem", "mixed_ard"])
def test_params_helpers_match_reference(kind):
    """params_per_problem, broadcast_params and gather_params against the reference's, leaf by leaf."""
    if kind == "mixed_ard":  # (B, D) ARD lengthscales beside a shared vertical and (B,) noises
        ls = np.asarray([[0.5, 1.0], [1.5, 2.0], [0.7, 0.9]], np.float32)
        kt, kj = tkm.ARDSquaredExponential(ndim=2), jkm.ARDSquaredExponential(ndim=2)
        pt = tkm.ARDKernelParams(torch.from_numpy(ls), 1.2, torch.from_numpy(NOISE))
        pj = jkm.ARDKernelParams(jnp.asarray(ls), 1.2, jnp.asarray(NOISE))
    else:
        (pt, pj), kt, kj = _params(kind), tkm.SquaredExponential(), jkm.SquaredExponential()
    assert tkm.params_per_problem(pt, kt) == jkm.params_per_problem(pj, kj) == (kind != "shared")
    got = tkm.tree_leaves(tkm.broadcast_params(pt, B, kt))
    want = jax.tree_util.tree_leaves(jkm.broadcast_params(pj, B, kj))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=0)
    for i in range(B):
        got = tkm.tree_leaves(tkm.gather_params(pt, i, kt))
        want = jax.tree_util.tree_leaves(jkm.gather_params(pj, i, kj))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w), rtol=0, atol=0)
