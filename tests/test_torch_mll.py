"""The port's hyperparameter training against the JAX package's ``repro.core.mll``.

Inputs come from a numpy seed.  The tiled NLML is held to the reference's
float32 tolerances (``tests/test_mll_grad.py``): value rtol 1e-4, gradient
rtol 1e-3 (atol 1e-3 of the largest component), for both ``vjp`` routes;
the Adam trajectory to the reference's tiled-against-monolithic tolerance
(losses rtol 1e-3 / atol 1e-2, params rtol 2e-2).  float64 packing is
checked against numpy (the JAX package's float64 mode raises here).
"""

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import pytest
import torch

from repro.core import kernels_math as jkm
from repro.core import mll as jmll
from repro.core.gp import GaussianProcess as JGP
import _jax_ref
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import GaussianProcess, cholesky, lowrank, predict
from repro_torch.core import kernels_math as tkm
from repro_torch.core import mll


def _data(n, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x.sum(-1)) + 0.3 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def _grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def _jax_value_and_grad(fn, raw):
    v, g = _jax_ref.jit(jax.value_and_grad(fn))(raw)  # eager, the tiled program's backward compiles op by op
    return float(v), np.asarray(g)


def _torch_value_and_grad(fn, raw):
    raw = torch.from_numpy(np.array(raw)).requires_grad_()
    v = fn(raw)
    return float(v.detach()), torch.autograd.grad(v, raw)[0].numpy()


# (kernel, vjp): SE and Matérn 5/2 on both routes; the composite has no hand-derived VJP
CELLS = [("se", "custom"), ("se", "autodiff"), ("matern52", "custom"), ("sum_m52_white", "custom")]


def _kernels(name):
    if name == "sum_m52_white":
        return jkm.Sum(jkm.Scaled(jkm.Matern52()), jkm.White()), tkm.Sum(tkm.Scaled(tkm.Matern52()), tkm.White())
    return jkm.get_kernel(name), tkm.get_kernel(name)


@pytest.mark.parametrize("name,vjp", CELLS)
def test_nlml_tiled_value_and_grad_match_the_reference(name, vjp):
    """n = 24, tile 16 (M = 2, padded): value and gradient in unconstrained space."""
    x, y = _data(24, seed=1)
    kj, kt = _kernels(name)
    pack_j, unpack_j = jmll._raw_codec(kj)
    _, unpack_t = mll._raw_codec(kt)
    init = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float32) * 1.1, kj.default_params())
    flat, unravel = ravel_pytree(pack_j(init, dtype=jnp.float32))
    se = isinstance(kt, tkm.SquaredExponential)  # SE's raw is the stacked (3,) vector, the others a tree
    t_treedef = tkm.tree_flatten(kt.default_params())[1]

    def jfn(r):
        return jmll.nlml_tiled(x, y, unpack_j(unravel(r)), tile_size=16, vjp=vjp, kernel=kj)

    def tfn(r):
        raw = r if se else tkm.tree_unflatten(t_treedef, list(r))
        return mll.nlml_tiled(x, y, unpack_t(raw), tile_size=16, vjp=vjp, kernel=kt, device="cpu")

    vj, gj = _jax_value_and_grad(jfn, jnp.asarray(flat))
    vt, gt = _torch_value_and_grad(tfn, flat)
    assert vt == pytest.approx(vj, rel=1e-4)
    _grad_close(gt, gj)


def test_custom_vjp_gradients_in_x_and_y_match_autodiff():
    """dNLML/dx and dNLML/dy of the blocked rule against autograd through the program (float64)."""
    x, y = _data(40, d=3, seed=2)
    p = tkm.SEKernelParams(0.9, 1.2, 0.15)
    out = {}
    for vjp in ("custom", "autodiff"):
        xt = torch.from_numpy(x).double().requires_grad_()
        yt = torch.from_numpy(y).double().requires_grad_()
        v = mll.nlml_tiled(xt, yt, p, tile_size=16, vjp=vjp, dtype=torch.float64, device="cpu")
        out[vjp] = [g.numpy() for g in torch.autograd.grad(v, (xt, yt))]
    for a, b in zip(out["custom"], out["autodiff"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_nlml_tiled_equals_the_dense_nlml_and_the_cached_state():
    x, y = _data(70, seed=3)
    p = tkm.SEKernelParams(0.8, 1.3, 0.2)
    tiled = float(mll.nlml_tiled(x, y, p, tile_size=32, device="cpu"))
    dense = float(mll.negative_log_marginal_likelihood(x, y, p, device="cpu"))
    state = predict.posterior_state(torch.from_numpy(x), torch.from_numpy(y), p, 32, device="cpu")
    cached = float(mll.nlml_from_state(state, y))
    ref = float(jmll.negative_log_marginal_likelihood(x, y, jkm.SEKernelParams(0.8, 1.3, 0.2)))
    assert tiled == pytest.approx(ref, rel=1e-4) and dense == pytest.approx(ref, rel=1e-4)
    assert cached == pytest.approx(ref, rel=1e-4)


def test_nlml_program_env_is_the_program_with_zero_test_tiles():
    x, y = _data(50, d=3, seed=4)
    p = tkm.SEKernelParams(0.8, 1.3, 0.2)
    env, yc = predict.nlml_program_env(torch.from_numpy(x), torch.from_numpy(y), p, 16, device="cpu")
    state = predict.posterior_state(torch.from_numpy(x), torch.from_numpy(y), p, 16, device="cpu")
    torch.testing.assert_close(env["packed"], state.lpacked, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(env["alpha"], state.alpha, rtol=1e-4, atol=1e-5)
    assert env["cross"].shape[0] == 0 and env["mean"].shape[0] == 0
    torch.testing.assert_close(yc, state.y_chunks, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def _values(n=48, seed=5):
    rng = np.random.default_rng(seed)
    return np.concatenate([[1e-8, 1e-6, 1.0, 19.5, 20.0, 20.5, 89.0, 95.0, 1e3, 1e6],
                           10.0 ** rng.uniform(-8, 6, size=n)])


def test_pack_roundtrip_float32_matches_the_reference():
    v = _values().astype(np.float32)
    raw_t = mll.pack_params(torch.from_numpy(v))
    raw_j = np.asarray(jmll.pack_params(jnp.asarray(v)))
    np.testing.assert_allclose(raw_t.numpy(), raw_j, rtol=1e-6, atol=1e-6)
    back = mll.unpack_params(raw_t).numpy()
    np.testing.assert_allclose(back, v, rtol=1e-5)
    assert np.isfinite(raw_t.numpy()).all()


def test_pack_roundtrip_float64_against_numpy():
    """float64 packing stays float64 and inverts softplus to float64 precision."""
    v = _values()
    raw = mll.pack_params(torch.from_numpy(v))
    assert raw.dtype == torch.float64
    want = np.where(v > 20.0, v + np.log1p(-np.exp(-np.maximum(v, 20.0))), np.log(np.expm1(np.minimum(v, 20.0))))
    np.testing.assert_allclose(raw.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(mll.unpack_params(raw).numpy(), v, rtol=1e-12)
    se = mll._pack(tkm.SEKernelParams(*(torch.tensor(a, dtype=torch.float64) for a in (1.5, 2.0, 0.3))))
    assert se.dtype == torch.float64 and se.shape == (3,)
    rt = mll._unpack(se)
    assert [float(rt.lengthscale), float(rt.vertical), float(rt.noise)] == pytest.approx([1.5, 2.0, 0.3], rel=1e-12)
    assert mll._pack(tkm.SEKernelParams.paper_defaults()).dtype == torch.float32


def test_pack_params_tree_and_gradients_across_the_branch():
    kern = tkm.Sum(tkm.Scaled(tkm.Matern52()), tkm.White())
    p = kern.default_params()
    raw = mll.pack_params(p)
    assert isinstance(raw, tuple) and isinstance(raw[0], tkm.ScaledParams)
    back = tkm.tree_leaves(mll.unpack_params(raw))
    np.testing.assert_allclose([float(b) for b in back], [float(a) for a in tkm.tree_leaves(p)], rtol=1e-6)
    v = torch.tensor([1e-8, 19.99, 20.0, 20.01, 1e4], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(mll._inv_softplus(v).sum(), v)
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_optimize_trajectory_matches_the_reference():
    """20 Adam steps through the tiled NLML (n = 40, tile 16) against the JAX package's scan."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-3, 3, (40, 1)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(40)).astype(np.float32)
    p_j, l_j = jmll.optimize_hyperparameters(x, y, jkm.SEKernelParams.paper_defaults(), steps=20, lr=0.05,
                                             method="tiled", tile_size=16)
    p_t, l_t = mll.optimize_hyperparameters(x, y, tkm.SEKernelParams.paper_defaults(), steps=20, lr=0.05,
                                            method="tiled", tile_size=16, device="cpu")
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-3, atol=1e-2)
    for a, b in zip((p_t.lengthscale, p_t.vertical, p_t.noise), (p_j.lengthscale, p_j.vertical, p_j.noise)):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-2, atol=1e-4)
    assert float(l_t[-1]) < float(l_t[0])
    # the monolithic path lands on the same hyperparameters
    p_m, l_m = mll.optimize_hyperparameters(x, y, tkm.SEKernelParams.paper_defaults(), steps=20, lr=0.05,
                                            method="monolithic", device="cpu")
    np.testing.assert_allclose(l_t.numpy(), l_m.numpy(), rtol=1e-3, atol=1e-2)


def test_adam_scan_names_match_the_reference():
    """``adam_scan``/``adam_scan_batched`` in the reference's call form: the same trajectory as the JAX scan
    on a quadratic, one run and three side by side."""
    target = np.asarray([[0.5, -1.0, 2.0], [1.5, 0.0, -0.5], [3.0, 1.0, 1.0]], np.float32)
    raw0 = np.zeros((3, 3), np.float32)
    r_j, l_j = jmll.adam_scan(lambda r: jnp.sum((r - target[0]) ** 2), 25, 0.1)(jnp.asarray(raw0[0]))
    r_t, l_t = mll.adam_scan(lambda r: torch.sum((r - torch.from_numpy(target[0])) ** 2), 25, 0.1)(
        torch.from_numpy(raw0[0]))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5, atol=1e-5)
    rb_j, lb_j = jmll.adam_scan_batched(lambda r: jnp.sum((r - target) ** 2, axis=-1), 25, 0.1)(jnp.asarray(raw0))
    rb_t, lb_t = mll.adam_scan_batched(lambda r: torch.sum((r - torch.from_numpy(target)) ** 2, dim=-1), 25, 0.1)(
        torch.from_numpy(raw0))
    assert lb_t.shape == (25, 3)
    np.testing.assert_allclose(rb_t.numpy(), np.asarray(rb_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j), rtol=1e-5, atol=1e-5)


def test_gp_optimize_tiled_runs_zero_dense_choleskys(monkeypatch):
    """pipeline="tiled" training never calls the dense Cholesky, and the NLML falls; matern52 as the reference."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-3, 3, (32, 1)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(32)).astype(np.float32)
    gp = GaussianProcess(x, y, tile_size=16, kernel="matern52", device="cpu")
    jgp = JGP(x, y, tile_size=16, kernel=jkm.Matern52())
    before = float(gp.nlml())
    assert before == pytest.approx(float(jgp.nlml()), rel=1e-4)
    assert float(gp.log_marginal_likelihood()) == pytest.approx(-before)
    calls = []
    monkeypatch.setattr(cholesky, "monolithic_cholesky", lambda *a: calls.append(1) or torch.linalg.cholesky(*a))
    gp.predict(x[:4])
    assert gp._cache_warm()
    gp.optimize(steps=10, lr=0.05)
    assert calls == [] and not gp._cache_warm()
    jgp.optimize(steps=10, lr=0.05)
    after = float(gp.nlml())
    assert after < before and after == pytest.approx(float(jgp.nlml()), rel=1e-3)


# ---------------------------------------------------------------------------
# The low-rank NLML
# ---------------------------------------------------------------------------


def test_nlml_lowrank_value_and_grad_match_the_reference():
    """n = 128, m_inducing = 32, tile 16, SE: the Woodbury NLML and its blocked gradient.

    The port's blocked rule runs in float64 (``mll._lr_grads``); the
    reference's contracts A^-1 and K_uu^-1 apart in the working dtype, which
    cancels in float32 at the default jitter (its float32 gradient here is up
    to 4% off the float64 value), so the float32 gradient is held against the
    reference's autodiff through the build.  ``GaussianProcess.nlml`` returns
    the value the training path takes.  The port's two routes also agree in float64, and the
    x and y cotangents with them.
    """
    x, y = _data(128, seed=12)
    raw = jmll._pack(jkm.SEKernelParams(0.9, 1.1, 0.2), dtype=jnp.float32)
    kw = dict(m_inducing=32, tile_size=16)
    vj, gj = _jax_value_and_grad(lambda r: jmll.nlml_lowrank(x, y, jmll._unpack(r), vjp="autodiff", **kw), raw)
    vt, gt = _torch_value_and_grad(lambda r: mll.nlml_lowrank(x, y, mll._unpack(r), device="cpu", **kw), raw)
    assert vt == pytest.approx(vj, rel=1e-4)
    _grad_close(gt, gj)
    p = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (0.9, 1.1, 0.2)]
    g = {}
    for route in ("custom", "autodiff"):
        xt = torch.from_numpy(x).double().requires_grad_()
        yt = torch.from_numpy(y).double().requires_grad_()
        val = mll.nlml_lowrank(xt, yt, tkm.SEKernelParams(*p), vjp=route, dtype=torch.float64, device="cpu", **kw)
        g[route] = [a.numpy() for a in torch.autograd.grad(val, p + [xt, yt])]
    for a, b in zip(g["custom"], g["autodiff"]):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)
    state = lowrank.lowrank_state(torch.from_numpy(x), torch.from_numpy(y),
                                  mll._unpack(torch.from_numpy(np.array(raw))), 32, 16, device="cpu")
    assert float(lowrank.whitened_nlml(state)) == pytest.approx(vt, rel=1e-6)
    gp = GaussianProcess(x, y, params=mll._unpack(torch.from_numpy(np.array(raw))), tile_size=16, method="lowrank",
                         m_inducing=32, device="cpu")
    assert float(gp.nlml()) == pytest.approx(vt, rel=1e-6)  # the value that optimize() trains
    # the reference's c . gamma form: the same value up to float32 rounding amplified by L_uu's conditioning
    assert float(lowrank.nlml_from_lowrank_state(state)) == pytest.approx(vt, rel=1e-4)
