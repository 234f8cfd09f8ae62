"""Port parity: the low-rank tier of ragged fleets (``GPFleet(method="lowrank")``) against the JAX package.

Four problems of 5, 20, 33 and 60 points in D = 2, tile 16, m_inducing 16,
in buckets of 2 and 4 tiles (``BOUNDS``, as ``tests/test_torch_ragged.py``
has them; two geometries keep the reference's compilations few).  Problem
0 has fewer rows than inducing slots, so its ``mu_valid`` is 5 beside the
others' 16.  The arrivals move problems 0 and 1 into the 4-tile bucket.
Inputs are made with numpy from a seed and handed to both packages; the
port runs on CPU tensors (the kernels' plain versions), the reference with
``op_backend="jnp"``, each JAX result computed once in a module-scoped
fixture.  Tolerances are those of ``tests/test_lowrank.py``'s fleet cells:
means and covariances 3e-4 (absolute), a warm update against a cold
rebuild 3e-3 (means) and 1e-3 (NLML, relative).  The fleet's NLML is the
whitened form (as ``GPBatch``'s), the reference's the c . gamma form, a
difference by design: held at 1e-4 relative here, where the two agree to
~5e-6; the reference's own form, on a state carried over, at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as jgp
from repro.core import kernels_math as jkm
from repro.core import lowrank as jlr
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import convert
from repro_torch.core import GaussianProcess, GPFleet, SEKernelParams
from repro_torch.core import executor as tex
from repro_torch.core import lowrank as tlr
from repro_torch.core import mll

CPU = "cpu"
M, D, MU = 16, 2, 16
NS = (5, 20, 33, 60)
ARRIVALS = (30, 20, 0, 3)  # 5 -> 35 and 20 -> 40 cross into the 4-tile bucket
BOUNDS = (2, 4)
LS, VERT, NOISE = 0.7, 1.2, 0.05


def _data(seed=0, ns=NS):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n, D)).astype(np.float32) for n in ns]
    ys = [(np.sin(x.sum(-1)) + 0.1 * rng.standard_normal(len(x))).astype(np.float32) for x in xs]
    return xs, ys


def _tests(seed=5):
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal((6, D)).astype(np.float32)
    each = [rng.standard_normal((k, D)).astype(np.float32) for k in (3, 0, 5, 2)]
    return shared, each


def _pinned(seed=9):
    return np.random.default_rng(seed).standard_normal((MU, D)).astype(np.float32)


def _close(got, want, tol, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), 1.0) if rel else 1.0
    assert np.all(np.abs(got - want) <= tol * scale), float(np.max(np.abs(got - want) / scale))


def _fleet(xs, ys, **kw):
    return GPFleet(xs, ys, params=SEKernelParams(LS, VERT, NOISE), tile_size=M, boundaries=BOUNDS,
                   method="lowrank", m_inducing=MU, device=CPU, **kw)


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference result of this file, computed once."""
    xs, ys = _data()
    shared, each = _tests()
    kw = dict(params=jkm.SEKernelParams(LS, VERT, NOISE), tile_size=M, boundaries=BOUNDS,
              method="lowrank", m_inducing=MU)
    fleet = jgp.GPFleet(xs, ys, **kw)
    mean, cov = fleet.predict_full_cov(shared)
    out = dict(mean=np.asarray(mean), cov=np.asarray(cov), nlml=np.asarray(fleet.nlml()),
               assignment=fleet.bucket_assignment())
    out["each"] = [(np.asarray(m), np.asarray(c)) for m, c in fleet.predict_each(each, full_cov=True)]
    out["state"] = fleet._buckets[2].state  # problems 0 and 1: mu_valid (5, 16), n_valid (5, 20)
    pinned = jgp.GPFleet(xs, ys, inducing=_pinned(), **kw)
    pinned.predict(shared)
    xa, ya = _data(seed=3, ns=ARRIVALS)
    pinned.update(xa, ya)
    out["migrated"] = pinned.bucket_assignment()
    out["after_update"] = np.asarray(pinned.predict(shared))
    out["nlml_after_update"] = np.asarray(pinned.nlml())
    return out


def test_lowrank_fleet_matches_jax_and_single_gps(ref):
    """Means, covariances and NLMLs of the ragged buckets against the reference's fleet, and each
    problem against its own single low-rank GP (the padding and the frontiers change nothing)."""
    xs, ys = _data()
    shared, _ = _tests()
    fleet = _fleet(xs, ys)
    assert fleet.bucket_assignment() == ref["assignment"] == {2: [0, 1], 4: [2, 3]}
    mean, cov = fleet.predict_full_cov(shared)
    _close(mean.numpy(), ref["mean"], 3e-4)
    _close(cov.numpy(), ref["cov"], 3e-4)
    nlml = fleet.nlml()
    _close(nlml.numpy(), ref["nlml"], 1e-4, rel=True)
    state = fleet._buckets[2].state
    assert state.mu_valid.tolist() == [5, 16] and state.n_valid.tolist() == [5, 20]
    for i in range(len(NS)):
        gp = GaussianProcess(xs[i], ys[i], params=SEKernelParams(LS, VERT, NOISE), tile_size=M,
                             method="lowrank", m_inducing=MU, device=CPU)
        mi, ci = gp.predict_full_cov(shared)
        _close(mean[i].numpy(), mi.numpy(), 3e-4)
        _close(cov[i].numpy(), ci.numpy(), 3e-4)
        _close(float(nlml[i]), float(gp.nlml()), 2e-5, rel=True)


def test_lowrank_predict_each_ragged_matches_jax(ref):
    """Per-problem test sets of 3, 0, 5 and 2 points slice back through the nt_valid frontier."""
    xs, ys = _data()
    _, each = _tests()
    fleet = _fleet(xs, ys)
    for full_cov in (True, False):
        got = fleet.predict_each(each, full_cov=full_cov)
        for g, (wm, wc), xt in zip(got, ref["each"], each):
            gm = g[0] if full_cov else g
            assert gm.shape == (len(xt),)
            _close(gm.numpy(), wm, 3e-4)
            if full_cov:
                assert g[1].shape == (len(xt), len(xt))
                _close(g[1].numpy(), wc, 3e-4)


def test_lowrank_migration_is_a_row_gather(ref, monkeypatch):
    """A problem outgrowing its bucket moves by a row gather of the mu-sized state and one ragged
    absorb per destination bucket: every bucket stays warm, K_uu is never factored again (the only
    Cholesky of the update is chol(B), once a destination), and warm equals a cold rebuild."""
    xs, ys = _data()
    shared, _ = _tests()
    xa, ya = _data(seed=3, ns=ARRIVALS)
    fleet = _fleet(xs, ys, inducing=_pinned())
    fleet.predict(shared)  # warm every bucket
    chols = []
    real = tex.run_cholesky
    monkeypatch.setattr(tlr.executor, "run_cholesky", lambda packed, **kw: chols.append(packed.shape) or real(packed, **kw))
    fleet.update(xa, ya)
    monkeypatch.undo()
    assert fleet.bucket_assignment() == ref["migrated"] == {4: [0, 1, 2, 3]}
    assert all(rec.state is not None for rec in fleet._buckets.values())
    assert len(chols) == len(fleet._buckets)  # chol(B) of each destination bucket, no chol(K_uu)
    state = fleet._buckets[4].state
    assert state.n_valid.tolist() == [35, 40, 33, 63]
    after = fleet.predict(shared)
    _close(after.numpy(), ref["after_update"], 3e-4)
    _close(fleet.nlml().numpy(), ref["nlml_after_update"], 1e-4, rel=True)
    cold = _fleet([np.concatenate([x, a]) for x, a in zip(xs, xa)], [np.concatenate([y, a]) for y, a in zip(ys, ya)],
                  inducing=_pinned())
    _close(after.numpy(), cold.predict(shared).numpy(), 3e-3)
    _close(fleet.nlml().numpy(), cold.nlml().numpy(), 1e-3, rel=True)


def test_ragged_batched_nlml_matches_loop():
    """Zero-padded ragged problems through ONE batched low-rank build give the single-problem NLMLs
    (``tests/test_lowrank.py``'s rule, rtol 2e-3), and the batched optimizer's first losses are them."""
    rng = np.random.default_rng(0)
    sizes, cap = (40, 64), 64
    xs = [rng.standard_normal((n, 2)).astype(np.float32) for n in sizes]
    ys = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    x = torch.stack([torch.nn.functional.pad(torch.from_numpy(a), (0, 0, 0, cap - len(a))) for a in xs])
    y = torch.stack([torch.nn.functional.pad(torch.from_numpy(a), (0, cap - len(a))) for a in ys])
    params = SEKernelParams(LS, VERT, NOISE)
    kw = dict(m_inducing=16, tile_size=M, device=CPU)
    vals = mll.nlml_lowrank_batched(x, y, params, n_valid=torch.tensor(sizes), **kw)
    loop = [float(mll.nlml_lowrank(xs[i], ys[i], params, vjp="autodiff", **kw)) for i in range(2)]
    _close(vals.detach().numpy(), loop, 2e-3, rel=True)
    _, losses = mll.optimize_hyperparameters_batched(x, y, params, steps=1, method="lowrank",
                                                     n_valid=torch.tensor(sizes), **kw)
    _close(losses[0].numpy(), loop, 2e-3, rel=True)


@pytest.mark.parametrize("strategy", ["subset", "kmeans-lite"])
def test_select_inducing_ragged_matches_jax(strategy):
    """Each problem draws only from its own first n_valid rows; mu_valid = min(m_inducing, n_valid)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40, 2)).astype(np.float32)
    nv = np.asarray([5, 40, 23], np.int32)
    uj, mvj = jlr.select_inducing(jnp.asarray(x), 16, strategy=strategy, n_valid=jnp.asarray(nv))
    ut, mvt = tlr.select_inducing(torch.from_numpy(x), 16, strategy=strategy, n_valid=torch.from_numpy(nv))
    assert mvt.dtype == torch.int32 and mvt.tolist() == np.asarray(mvj).tolist() == [5, 16, 16]
    _close(ut.numpy(), np.asarray(uj), 1e-6)


def test_ragged_absorb_with_counts_matches_rebuild():
    """A ragged block (2 and 0 of 3 padded rows valid) absorbed with ``counts`` equals a cold build of the
    grown problems; the padded rows, non-zero on purpose, add nothing."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    y = rng.standard_normal((2, 32)).astype(np.float32)
    nv = [20, 31]
    xb = rng.standard_normal((2, 3, D)).astype(np.float32)
    yb = rng.standard_normal((2, 3)).astype(np.float32)
    u = _pinned()
    params = SEKernelParams(LS, VERT, NOISE)
    kw = dict(inducing=u, device=CPU)
    st = tlr.lowrank_state(x, y, params, MU, M, n_valid=torch.tensor(nv), **kw)
    st = tlr.absorb(st, xb, yb, torch.tensor([2, 0]))
    assert st.n_valid.tolist() == [22, 31]
    grown_x = np.zeros((2, 32, D), np.float32)
    grown_y = np.zeros((2, 32), np.float32)
    grown_x[0, :22] = np.concatenate([x[0, :20], xb[0, :2]])
    grown_y[0, :22] = np.concatenate([y[0, :20], yb[0, :2]])
    grown_x[1, :31], grown_y[1, :31] = x[1, :31], y[1, :31]
    cold = tlr.lowrank_state(grown_x, grown_y, params, MU, M, n_valid=torch.tensor([22, 31]), **kw)
    xt = torch.from_numpy(rng.standard_normal((2, 5, D)).astype(np.float32))
    _close(tlr.predict_from_lowrank_state(st, xt).numpy(), tlr.predict_from_lowrank_state(cold, xt).numpy(), 3e-4)
    _close(tlr.whitened_nlml(st).numpy(), tlr.whitened_nlml(cold).numpy(), 1e-4, rel=True)
    _close(st.yty.numpy(), cold.yty.numpy(), 1e-5, rel=True)


def test_ragged_state_carried_over_from_jax(ref):
    """A JAX low-rank bucket state ((B,) n_valid and mu_valid) crosses over through convert.py."""
    st = ref["state"]
    shared, _ = _tests()
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(st.params)]
    state = convert.lowrank_state_from_numpy(
        *(np.asarray(getattr(st, f)) for f in ("u_chunks", "luu_packed", "b_packed", "lb_packed", "c_chunks",
                                               "gamma", "yty")),
        st.n, st.m, st.m_inducing, convert.kernel_params_from_numpy("se", leaves), st.jitter,
        np.asarray(st.mu_valid), np.asarray(st.n_valid), device=CPU,
    )
    assert state.mu_valid.tolist() == [5, 16] and state.n_valid.tolist() == [5, 20]
    xt = torch.from_numpy(np.broadcast_to(shared, (2,) + shared.shape).copy())
    mean, cov = tlr.predict_from_lowrank_state(state, xt, full_cov=True)
    _close(mean.numpy(), ref["mean"][:2], 1e-5)
    _close(cov.numpy(), ref["cov"][:2], 1e-5)
    _close(tlr.nlml_from_lowrank_state(state).numpy(), ref["nlml"][:2], 1e-5, rel=True)
    with pytest.raises(ValueError, match="stacked state"):
        convert.lowrank_state_from_numpy(
            *(np.asarray(getattr(st, f))[0] for f in ("u_chunks", "luu_packed", "b_packed", "lb_packed",
                                                      "c_chunks", "gamma", "yty")),
            st.n, st.m, st.m_inducing, SEKernelParams(LS, VERT, NOISE), st.jitter, None, [5], device=CPU,
        )


def test_lowrank_fleet_optimize_fits_each_problem_alone():
    """``optimize`` on the low-rank tier: each problem's own Nystrom fit, stacked into (B,) leaves."""
    xs, ys = _data()
    fleet = _fleet(xs, ys).optimize(steps=2, lr=0.05)
    assert fleet.params.lengthscale.shape == (4,) and not fleet._buckets
    for i in (0, 3):
        want, _ = mll.optimize_hyperparameters(xs[i], ys[i], SEKernelParams(LS, VERT, NOISE), steps=2, lr=0.05,
                                               method="lowrank", m_inducing=MU, tile_size=M, device=CPU)
        _close(float(fleet.params.lengthscale[i]), float(want.lengthscale), 1e-6)
    assert torch.isfinite(fleet.nlml()).all()
