"""Port parity: the Nystrom low-rank tier (``method="lowrank"``) against the JAX package.

The port runs on CPU tensors (``device="cpu"``: the kernels' plain versions,
``lrgemm_plain`` among them); the reference is ``repro.core.lowrank`` and
the JAX ``GaussianProcess`` with ``op_backend="jnp"`` and, where stated,
``"pallas"`` (interpret mode), at tile 16 and a few dozen points, as
``tests/test_lowrank.py`` runs them.  Inputs are made with numpy from a
seed and handed to both; a JAX state crosses over with
``convert.lowrank_state_from_numpy``.  Tolerances are those of
``tests/test_lowrank.py`` (2e-2 to the exact GP at m_inducing = n, 2e-3
for Pallas parity and for warm-against-cold, 5e-3 for an unaligned
forget); port against the jnp reference is held to 1e-4, scaled by the
magnitude of the compared field where it exceeds 1 (the inner matrix B
reaches s^-2 n v^2 ~ 1e3, where one float32 ulp is ~1e-4).  float64 is
checked against a numpy dense DTC at 1e-10 (the JAX package's
``enable_x64`` helper does not run here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GaussianProcess as JaxGP
from repro.core import executor as jex
from repro.core import lowrank as jlr
from repro.core import scheduler as jsch
from repro.core.kernels_math import SEKernelParams as JaxParams
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import convert
from repro_torch.core import GaussianProcess, SEKernelParams
from repro_torch.core import executor as tex
from repro_torch.core import lowrank as tlr
from repro_torch.core import scheduler as tsch
from repro_torch.core import tiling as ttil
from repro_torch.core import update as tupd
from repro_torch.kernels import ops

CPU = "cpu"
M = 16
JPARAMS = JaxParams(lengthscale=0.7, vertical=1.2, noise=0.05)
PARAMS = SEKernelParams(0.7, 1.2, 0.05)
STATE_FIELDS = ("luu_packed", "b_packed", "lb_packed", "c_chunks", "gamma", "yty")


def T(a):
    return torch.from_numpy(np.array(a))


def _data(rng, n, d=2, nt=7, dtype=np.float32):
    x = rng.standard_normal((n, d)).astype(dtype)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(dtype)
    xt = rng.standard_normal((nt, d)).astype(dtype)
    return x, y, xt


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|): ``tol`` relative to the field's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _gp(x, y, **kw):
    return GaussianProcess(x, y, params=PARAMS, tile_size=M, method="lowrank", device=CPU, **kw)


def _jgp(x, y, **kw):
    return JaxGP(x, y, params=JPARAMS, tile_size=M, method="lowrank", **kw)


# ---------------------------------------------------------------------------
# scheduler / executor: the LRGEMM family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mu_tiles,n_tiles", [(1, 1), (2, 3), (4, 5)])
@pytest.mark.parametrize("n_streams", [1, 2, 5])
def test_lowrank_dag_matches_reference(mu_tiles, n_tiles, n_streams):
    assert tsch.lowrank_tasks(mu_tiles, n_tiles) == jsch.lowrank_tasks(mu_tiles, n_tiles)
    assert tsch.LRGEMM == jsch.LRGEMM and tsch.LRGEMM in tsch.BULK_OPS
    got = tsch.build_wavefront_schedule(mu_tiles, n_streams, kind="lowrank", q_tiles=n_tiles)
    want = jsch.build_wavefront_schedule(mu_tiles, n_streams, kind="lowrank", q_tiles=n_tiles)
    assert got.levels == want.levels and len(got.levels) == 1  # a bulk family rides one wave
    for t in got.levels[0]:
        assert tsch.task_deps(t, got) == jsch.task_deps(t, want) == []
    with pytest.raises(ValueError):
        tsch.lowrank_deps((tsch.POTRF, 0, 0, -1))


@pytest.mark.parametrize("mu_tiles,n_tiles", [(1, 1), (2, 3), (4, 5)])
@pytest.mark.parametrize("n_streams", [None, 1, 2])
def test_lowrank_plan_matches_reference(mu_tiles, n_tiles, n_streams):
    got = tex.lowrank_plan(mu_tiles, n_tiles, n_streams)
    want = jex.lowrank_plan(mu_tiles, n_tiles, n_streams)
    assert got.kind == want.kind == "lowrank" and got.n_batches == 1
    assert got.launches_by_op() == {tsch.LRGEMM: 1}  # never chunked by the pool
    (gb,), (wb,) = got.levels[0], want.levels[0]
    assert gb.tasks == wb.tasks and gb.op == wb.op
    for f in ("out", "a", "b"):
        np.testing.assert_array_equal(getattr(gb, f), getattr(wb, f))
    np.testing.assert_array_equal(gb.a, np.arange(mu_tiles * n_tiles))  # the identity


@pytest.mark.parametrize("mb", [M, 8])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_run_lowrank_contraction_matches_reference(rng, mb, backend):
    """c = K_un y over a (3, 4) grid, m = 16 and mb = 16 or 8; float32 at 1e-5."""
    kun = rng.standard_normal((3, 4, M, mb)).astype(np.float32)
    yc = rng.standard_normal((4, mb)).astype(np.float32)
    want = jex.run_lowrank_contraction(jnp.asarray(kun), jnp.asarray(yc), backend=backend)
    ops.reset_launch_counts()
    got = tex.run_lowrank_contraction(T(kun), T(yc), device=CPU)
    assert got.shape == (3, M) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.einsum("pjab,jb->pa", kun, yc), atol=1e-5)
    assert ops.launch_counts()["lrgemm"] == 0  # CPU tensors: the plain version


# ---------------------------------------------------------------------------
# inducing-point selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mu,nv", [(8, 40), (16, 16), (24, 10), (5, 1), (7, 57)])
def test_subset_indices_match_reference(mu, nv):
    got = tlr._subset_indices(mu, nv, CPU).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlr._subset_indices(mu, nv)))


@pytest.mark.parametrize("n,mu", [(57, 24), (20, 32)])
def test_select_inducing_subset_matches_reference(rng, n, mu):
    x = rng.standard_normal((n, 3)).astype(np.float32)
    u, mv = tlr.select_inducing(T(x), mu)
    ju, jmv = jlr.select_inducing(jnp.asarray(x), mu)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    assert mv == jmv == (None if n >= mu else n)


def test_select_inducing_kmeans_lite_matches_reference(rng):
    """Four well-separated clusters, so no assignment sits near a tie: the
    centers agree to float32 rounding (1e-5)."""
    centers = np.array([[-6.0, 0.0], [6.0, 0.0], [0.0, 6.0], [0.0, -6.0]], np.float32)
    x = (centers[rng.integers(0, 4, 80)] + 0.3 * rng.standard_normal((80, 2))).astype(np.float32)
    u, _ = tlr.select_inducing(T(x), 8, strategy="kmeans-lite")
    ju, _ = jlr.select_inducing(jnp.asarray(x), 8, strategy="kmeans-lite")
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-5)
    assert not u.requires_grad


def test_selection_and_method_validation():
    x = torch.zeros((4, 1))
    with pytest.raises(ValueError, match="inducing"):
        tlr.select_inducing(x, 8, inducing=torch.zeros((5, 1)))
    with pytest.raises(ValueError, match="strategy"):
        tlr.select_inducing(x, 2, strategy="bogus")
    y = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="method"):
        GaussianProcess(x, y, method="nope", device=CPU)
    with pytest.raises(ValueError, match="m_inducing"):
        GaussianProcess(x, y, method="lowrank", device=CPU)


# ---------------------------------------------------------------------------
# the state, field by field
# ---------------------------------------------------------------------------


def _k(a, b):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return 1.2 * np.exp(-0.5 / 0.7 * d2)


def _numpy_state(x, y, u, m_inducing, jitter=1e-4):
    """The state's fields in float64 from dense numpy, padded as the tiled build pads:
    K_uu identity past the distinct inducing points, K_un zero there and past n."""
    n, mv = len(x), len(u)
    mp, n_pad = -(-m_inducing // M) * M, -(-n // M) * M
    kuu = np.eye(mp)
    kuu[:mv, :mv] = _k(u, u) + jitter * np.eye(mv)
    kun = np.zeros((mp, n_pad))
    kun[:mv, :n] = _k(u, x)
    yp = np.zeros(n_pad)
    yp[:n] = y
    luu = np.linalg.cholesky(kuu)
    w = np.linalg.solve(luu, kun)
    b = np.eye(mp) + w @ w.T / 0.05
    lb = np.linalg.cholesky(b)
    c = kun @ yp
    z = np.linalg.solve(lb, np.linalg.solve(luu, c))
    gamma = np.linalg.solve(luu.T, np.linalg.solve(lb.T, z))

    def pack(a):
        return ttil.pack_lower(torch.from_numpy(a), M).numpy()

    return dict(luu_packed=pack(luu), b_packed=pack(b), lb_packed=pack(lb),
                c_chunks=c.reshape(-1, M), gamma=gamma.reshape(-1, M), yty=yp @ yp,
                c_w=(w @ yp).reshape(-1, M))


@pytest.mark.parametrize("n,mu", [(48, 24), (57, 24), (57, 70)])
def test_lowrank_state_matches_reference(rng, n, mu):
    """Every field of the state at n in {48, 57} (a tile multiple, and odd),
    m_inducing < n, and m_inducing > n (57 distinct inducing points).

    The fields that no solve touches (u, c = K_un y, y^T y) agree with the
    jnp reference to 1e-4 of their scale.  The factors and gamma = A^-1 c
    pass through K_uu, whose condition number at jitter 1e-4 amplifies
    float32 rounding: there the JAX package's own jnp and Pallas builds
    differ by up to ~1e-2 of scale.  So each of those fields is held to
    the reference's own accuracy: its error against a float64 numpy build
    at most 2x the larger error of the jnp and Pallas builds, plus 1e-4 of
    its scale (the rule of the chip run's accuracy check).  The field the
    port adds, c_w = W y, has no JAX counterpart: it is held to the same
    rule against L_uu^-1 c formed from each JAX build's own fields.
    """
    x, y, _ = _data(rng, n)
    js = jlr.lowrank_state(jnp.asarray(x), jnp.asarray(y), JPARAMS, mu, M)
    jp = jlr.lowrank_state(jnp.asarray(x), jnp.asarray(y), JPARAMS, mu, M, backend="pallas")
    ts = tlr.lowrank_state(T(x), T(y), PARAMS, mu, M, device=CPU)
    np.testing.assert_array_equal(ts.u_chunks.numpy(), np.asarray(js.u_chunks))
    assert (ts.n, ts.m, ts.m_inducing, ts.jitter) == (js.n, js.m, js.m_inducing, js.jitter)
    assert ts.mu_valid == (None if js.mu_valid is None else int(js.mu_valid))
    for f in ("c_chunks", "yty"):
        _close(getattr(ts, f).numpy(), getattr(js, f), 1e-4)
    x64 = x.astype(np.float64)
    u = x64[np.asarray(jlr._subset_indices(mu, n))][: min(n, mu)]  # the distinct inducing points
    truth = _numpy_state(x64, y.astype(np.float64), u, mu)
    for f in STATE_FIELDS:
        want = truth[f]
        scale = max(1.0, float(np.abs(want).max()))
        err = {k: float(np.abs(np.asarray(getattr(st, f), np.float64) - want).max())
               for k, st in (("port", ts), ("jnp", js), ("pallas", jp))}
        assert err["port"] <= 2 * max(err["jnp"], err["pallas"]) + 1e-4 * scale, (f, err)
    def c_w_of(st):  # L_uu^-1 c from a JAX build's fields, solved in float64
        luu = ttil.unpack_lower(T(st.luu_packed).double()).numpy()
        return np.linalg.solve(luu, np.asarray(st.c_chunks, np.float64).reshape(-1))

    want = truth["c_w"].reshape(-1)
    err_ref = max(np.abs(c_w_of(st) - want).max() for st in (js, jp))
    err_port = np.abs(ts.c_w.numpy().reshape(-1) - want).max()
    assert err_port <= 2 * err_ref + 1e-4 * max(1.0, np.abs(want).max()), (err_port, err_ref)
    np.testing.assert_allclose(
        float(tlr.nlml_from_lowrank_state(ts)), float(jlr.nlml_from_lowrank_state(js)), rtol=1e-4
    )


def test_lowrank_state_launch_free_on_cpu_and_inputs_unchanged(rng):
    x, y, _ = _data(rng, 40)
    tx, ty = T(x), T(y)
    ops.reset_launch_counts()
    tlr.lowrank_state(tx, ty, PARAMS, 16, M, device=CPU)
    assert all(v == 0 for v in ops.launch_counts().values())
    np.testing.assert_array_equal(tx.numpy(), x)
    np.testing.assert_array_equal(ty.numpy(), y)


def test_state_carried_over_from_jax_predicts_the_same(rng):
    x, y, xt = _data(rng, 57)
    js = jlr.lowrank_state(jnp.asarray(x), jnp.asarray(y), JPARAMS, 24, M)
    p = js.params
    ts = convert.lowrank_state_from_numpy(
        *(np.asarray(getattr(js, f)) for f in ("u_chunks", "luu_packed", "b_packed", "lb_packed",
                                              "c_chunks", "gamma", "yty")),
        js.n, js.m, js.m_inducing, convert.params_from_numpy(p.lengthscale, p.vertical, p.noise),
        js.jitter, js.mu_valid, device=CPU,
    )
    jm, jc = jlr.predict_from_lowrank_state(js, jnp.asarray(xt), full_cov=True)
    tm, tc = tlr.predict_from_lowrank_state(ts, T(xt), full_cov=True)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(
        float(tlr.nlml_from_lowrank_state(ts)), float(jlr.nlml_from_lowrank_state(js)), rtol=1e-6
    )
    with pytest.raises(ValueError, match="inconsistent"):
        convert.lowrank_state_from_numpy(
            np.asarray(js.u_chunks), np.asarray(js.luu_packed)[:1], np.asarray(js.b_packed),
            np.asarray(js.lb_packed), np.asarray(js.c_chunks), np.asarray(js.gamma),
            np.asarray(js.yty), js.n, js.m, js.m_inducing, PARAMS, js.jitter, device=CPU,
        )


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [48, 57])
def test_gp_full_rank_matches_exact(rng, n):
    """m_inducing = n, u = x: DTC equals the exact GP up to the K_uu jitter (2e-2)."""
    x, y, xt = _data(rng, n)
    m_lr, c_lr = _gp(x, y, m_inducing=n, inducing=x).predict_full_cov(xt)
    m_ex, c_ex = GaussianProcess(x, y, params=PARAMS, tile_size=M, device=CPU).predict_full_cov(xt)
    np.testing.assert_allclose(m_lr.numpy(), m_ex.numpy(), atol=2e-2)
    np.testing.assert_allclose(c_lr.numpy(), c_ex.numpy(), atol=2e-2)


@pytest.mark.parametrize("backend,tol", [("jnp", 1e-4), ("pallas", 2e-3)])
@pytest.mark.parametrize("strategy", ["subset", "kmeans-lite"])
def test_gp_predictions_match_jax(rng, backend, tol, strategy):
    """predict / predict_full_cov / predict_with_uncertainty against the JAX
    front end.  kmeans-lite is compared on its predictions: a center may
    move by an argmin near-tie, and the posterior barely notices."""
    x, y, xt = _data(rng, 64, nt=9)
    g = _gp(x, y, m_inducing=M, strategy=strategy)
    jg = _jgp(x, y, m_inducing=M, strategy=strategy, op_backend=backend)
    np.testing.assert_allclose(g.predict(xt).numpy(), np.asarray(jg.predict(xt)), atol=tol)
    mean, cov = g.predict_full_cov(xt)
    jmean, jcov = jg.predict_full_cov(xt)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=tol)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), atol=tol)
    mu, var = g.predict_with_uncertainty(xt)
    jmu, jvar = jg.predict_with_uncertainty(xt)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=tol)
    assert bool((var >= 0).all())
    # the NLML reads c^T gamma, and the port solves gamma from c_w = W y
    # (lowrank's module docstring): 1e-3, the reference's warm-against-cold NLML tolerance
    np.testing.assert_allclose(
        float(tlr.nlml_from_lowrank_state(g.lowrank_posterior())), float(jg.nlml()), rtol=1e-3
    )


def test_gp_variance_nonnegative_and_cache(rng):
    x, y, xt = _data(rng, 120, nt=21)
    g = _gp(x, y, m_inducing=32)
    _, var = g.predict_with_uncertainty(xt)
    assert bool((var >= 0).all())
    state = g.lowrank_posterior()
    g.predict(xt)
    assert g._lowrank_warm() and g.lowrank_posterior() is state and g._posterior is None
    g.params = SEKernelParams(0.9, 1.2, 0.05)  # new hyperparameters: a new state
    assert not g._lowrank_warm()
    g.invalidate_cache()
    assert g._lowrank is None


def test_gp_copies_and_keys_on_the_inducing_set(rng):
    x, y, xt = _data(rng, 40)
    u = T(x[:M])
    g = _gp(x, y, m_inducing=M, inducing=u)
    before = g.predict(xt)
    u += 1.0  # the caller's tensor: the GP holds its own copy
    assert g._lowrank_warm()
    np.testing.assert_array_equal(g.predict(xt).numpy(), before.numpy())
    g.inducing += 0.5  # an in-place edit of the GP's own set invalidates
    assert not g._lowrank_warm()
    assert not np.allclose(g.predict(xt).numpy(), before.numpy())


def test_predict_lowrank_matches_reference(rng):
    x, y, xt = _data(rng, 57)
    got = tlr.predict_lowrank(T(x), T(y), T(xt), PARAMS, 24, M, device=CPU)
    want = jlr.predict_lowrank(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), JPARAMS, 24, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# streaming: absorb / forget / sliding window
# ---------------------------------------------------------------------------


def test_update_absorbs_warm_and_matches_cold_and_jax(rng):
    x, y, xt = _data(rng, 70)
    xb, yb, _ = _data(rng, 9)
    u = x[:24]  # pinned inducing set: warm and cold are the same model
    g = _gp(x, y, m_inducing=24, inducing=u)
    jg = _jgp(x, y, m_inducing=24, inducing=u)
    g.predict(xt)
    jg.predict(xt)
    g.update(xb, yb)
    jg.update(xb, yb)
    assert g._lowrank_warm() and g.lowrank_posterior().n == 79
    cold = _gp(np.concatenate([x, xb]), np.concatenate([y, yb]), m_inducing=24, inducing=u)
    np.testing.assert_allclose(g.predict(xt).numpy(), cold.predict(xt).numpy(), atol=2e-3)
    np.testing.assert_allclose(g.predict(xt).numpy(), np.asarray(jg.predict(xt)), atol=1e-4)
    np.testing.assert_allclose(
        float(tlr.nlml_from_lowrank_state(g.lowrank_posterior())),
        float(tlr.nlml_from_lowrank_state(cold.lowrank_posterior())), rtol=1e-3,
    )


def test_forget_downdates_warm_any_k(rng):
    """A sign=-1 absorb needs no tile alignment: k = 13 stays warm (5e-3 to cold)."""
    x, y, xt = _data(rng, 80)
    u = x[40:64]
    g = _gp(x, y, m_inducing=24, inducing=u)
    jg = _jgp(x, y, m_inducing=24, inducing=u)
    g.predict(xt)
    jg.predict(xt)
    g.forget(13)
    jg.forget(13)
    assert g._lowrank_warm() and g.x_train.shape[0] == 67
    cold = _gp(x[13:], y[13:], m_inducing=24, inducing=u)
    np.testing.assert_allclose(g.predict(xt).numpy(), cold.predict(xt).numpy(), atol=5e-3)
    # the downdate B - s^-2 W_b W_b^T cancels, which amplifies the rounding of
    # the two orders of summation: 2e-3, the reference's parity between its
    # own two backends
    np.testing.assert_allclose(g.predict(xt).numpy(), np.asarray(jg.predict(xt)), atol=2e-3)


def test_sliding_window_evicts_exact_count(rng):
    x, y, xt = _data(rng, 60)
    u = x[:16]
    g = _gp(x, y, m_inducing=16, inducing=u, sliding_window=60)
    jg = _jgp(x, y, m_inducing=16, inducing=u, sliding_window=60)
    g.predict(xt)
    jg.predict(xt)
    xb, yb, _ = _data(rng, 10)
    ops.reset_launch_counts()
    g.update(xb, yb)
    jg.update(xb, yb)
    assert g.x_train.shape[0] == 60  # exact eviction, no tile rounding
    assert g._lowrank_warm() and g.lowrank_posterior().n == 60
    np.testing.assert_array_equal(g.x_train.numpy(), np.concatenate([x, xb])[10:])
    np.testing.assert_allclose(g.predict(xt).numpy(), np.asarray(jg.predict(xt)), atol=1e-4)
    cold = _gp(g.x_train, g.y_train, m_inducing=16, inducing=u)
    np.testing.assert_allclose(g.predict(xt).numpy(), cold.predict(xt).numpy(), atol=2e-3)


def test_update_cold_cache_and_failed_downdate(rng, monkeypatch):
    x, y, xt = _data(rng, 40)
    g = _gp(x, y, m_inducing=M)
    xb, yb, _ = _data(rng, 5)
    g.update(xb, yb)  # never predicted: nothing to absorb into
    assert g._lowrank is None and g.x_train.shape[0] == 45
    g.predict(xt)

    def fail(*a, **k):
        raise tupd.CholeskyUpdateError("forced")

    monkeypatch.setattr(tlr, "absorb", fail)
    g.forget(3)  # a failed downdate leaves the cache cold; the next predict rebuilds
    assert g._lowrank is None
    monkeypatch.undo()
    cold = _gp(np.concatenate([x, xb])[3:], np.concatenate([y, yb])[3:], m_inducing=M)
    np.testing.assert_array_equal(g.predict(xt).numpy(), cold.predict(xt).numpy())


def test_absorb_raises_on_an_indefinite_downdate(rng):
    x, y, _ = _data(rng, 40)
    state = tlr.lowrank_state(T(x), T(y), PARAMS, M, M, device=CPU)
    xb = T(np.repeat(x[:1], 30, axis=0))  # 30 copies of a row the state holds once
    with pytest.raises(tupd.CholeskyUpdateError, match="refactorization"):
        tlr.absorb(state, xb, torch.zeros(30), sign=-1)
    # the input state is untouched
    assert state.n == 40


def test_jitter_retry_recovers(rng):
    """Duplicate inducing rows with jitter 0: K_uu is singular, the first
    build goes non-finite, and the escalated jitter (1e-3) recovers."""
    x = np.repeat(rng.standard_normal((4, 2)), 8, axis=0).astype(np.float32)
    y = rng.standard_normal(32).astype(np.float32)
    ind = np.repeat(x[:1], 8, axis=0)
    g = _gp(x, y, m_inducing=8, inducing=ind, jitter=0.0)
    mean = g.predict(x[:4])
    assert bool(torch.isfinite(mean).all())
    assert g.lowrank_posterior().jitter == pytest.approx(1e-3)
    jmean = np.asarray(_jgp(x, y, m_inducing=8, inducing=ind, jitter=0.0).predict(x[:4]))
    np.testing.assert_allclose(mean.numpy(), jmean, atol=2e-3)


# ---------------------------------------------------------------------------
# accuracy: float64 against a numpy dense DTC, float32 against the dense rule
# ---------------------------------------------------------------------------


def _dense_dtc(x, y, xt, u, jitter):
    """Whitened dense DTC in numpy float64, SGPR form (l = 0.7, v = 1.2, s^2 = 0.05)."""
    luu = np.linalg.cholesky(_k(u, u) + jitter * np.eye(len(u)))
    w = np.linalg.solve(luu, _k(u, x))
    lb = np.linalg.cholesky(np.eye(len(u)) + w @ w.T / 0.05)
    v1 = np.linalg.solve(luu, _k(u, xt))
    v2 = np.linalg.solve(lb, v1)
    mean = v2.T @ np.linalg.solve(lb, w @ y) / 0.05
    cov = _k(xt, xt) - v1.T @ v1 + v2.T @ v2
    return mean, cov


@pytest.mark.parametrize("n,mu", [(57, 24), (48, 48)])
def test_float64_matches_numpy_dense_dtc(rng, n, mu):
    x, y, xt = _data(rng, n, dtype=np.float64)
    u = x[tlr._subset_indices(mu, n, CPU).numpy()]
    g = GaussianProcess(x, y, params=PARAMS, tile_size=M, method="lowrank", m_inducing=mu,
                        jitter=1e-4, dtype=torch.float64, device=CPU)
    mean, cov = g.predict_full_cov(xt)
    assert mean.dtype == torch.float64
    rmean, rcov = _dense_dtc(x, y, xt, u, 1e-4)
    np.testing.assert_allclose(mean.numpy(), rmean, atol=1e-10)
    np.testing.assert_allclose(cov.numpy(), rcov, atol=1e-10)
    # a warm absorb of 9 rows, against the dense DTC of the grown set
    xb, yb, _ = _data(rng, 9, dtype=np.float64)
    g.update(xb, yb)
    assert g._lowrank_warm()
    rmean, _ = _dense_dtc(np.concatenate([x, xb]), np.concatenate([y, yb]), xt, u, 1e-4)
    np.testing.assert_allclose(g.predict(xt).numpy(), rmean, atol=1e-10)


def _dense_sgpr_f32(x, y, xt, u, jitter):
    """The dense DTC mean in float32 numpy (LAPACK), SGPR form: what a user would otherwise run."""
    f = np.float32
    luu = np.linalg.cholesky((_k(u, u) + jitter * np.eye(len(u))).astype(f))
    w = np.linalg.solve(luu, _k(u, x).astype(f))
    lb = np.linalg.cholesky(np.eye(len(u), dtype=f) + w @ w.T / f(0.05))
    v2 = np.linalg.solve(lb, np.linalg.solve(luu, _k(u, xt).astype(f)))
    return v2.T @ np.linalg.solve(lb, w @ y) / f(0.05)


@pytest.mark.parametrize("n,d,mu", [(512, 1, 64), (1024, 2, 128)])
def test_float32_mean_meets_the_dense_accuracy_rule(n, d, mu):
    """Ill-conditioned K_uu (dense inducing points, jitter 1e-4), float32.

    The port's mean, against a float64 dense DTC, is within 2x the float32
    dense SGPR pipeline's error plus 1e-4 of the mean's scale (the chip run's
    rule), and no less accurate than the JAX package, whose gamma solved
    from c = K_un y loses ~20-80x more here (see ``lowrank``'s module
    docstring).
    """
    rng = np.random.default_rng(0)
    x = rng.uniform(-3, 3, (n, d)).astype(np.float32)
    y = (np.sin(x.sum(1)) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    xt = rng.uniform(-3, 3, (50, d)).astype(np.float32)
    u = x[np.asarray(jlr._subset_indices(mu, n))]
    ref, _ = _dense_dtc(*(a.astype(np.float64) for a in (x, y, xt, u)), 1e-4)
    err_port = np.abs(_gp(x, y, m_inducing=mu).predict(xt).numpy() - ref).max()
    err_jax = np.abs(np.asarray(_jgp(x, y, m_inducing=mu).predict(xt)) - ref).max()
    err_dense = np.abs(_dense_sgpr_f32(x, y, xt, u, 1e-4) - ref).max()
    assert err_port <= 2 * err_dense + 1e-4 * np.abs(ref).max()
    assert err_port <= err_jax
