"""Port parity: streaming updates (append, evict, sliding window) against the JAX package.

The port runs on CPU tensors (``device="cpu"``: the kernels' plain
versions, ``carry_update_plain`` among them); the reference is the JAX
package's ``repro.core.update`` with the jnp backend and, at n <= 50, with
the Pallas kernels in interpret mode, as ``tests/test_update.py`` runs it.
Inputs are made with numpy from a seed and handed to both; a JAX state
crosses over with ``convert.posterior_state_from_numpy``.  Tolerances are
those of ``tests/test_update.py``; float64 is checked against numpy/scipy
(the JAX package's ``enable_x64`` helper does not run here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from repro.core import GaussianProcess as JaxGP
from repro.core import SEKernelParams as JaxParams
from repro.core import executor as jex
from repro.core import predict as jpred
from repro.core import scheduler as jsch
from repro.core import tiling as jtil
from repro.core import update as jupd
from repro.kernels import downdate_tile as jdown
from repro_torch import convert
from repro_torch.core import GaussianProcess
from repro_torch.core import executor as tex
from repro_torch.core import predict as tpred
from repro_torch.core import scheduler as tsch
from repro_torch.core import tiling as ttil
from repro_torch.core import update as tupd
from repro_torch.kernels import carry_update, ops

CPU = "cpu"
JPARAMS = JaxParams.paper_defaults()
STREAMS = [None, 1, 2, 5]


def T(a):
    return torch.from_numpy(np.array(a))


def _data(rng, n, d=2, dtype=np.float32):
    return rng.standard_normal((n, d)).astype(dtype), rng.standard_normal(n).astype(dtype)


def _jax_state(x, y, m, backend="jnp"):
    return jpred.posterior_state(jnp.asarray(x), jnp.asarray(y), JPARAMS, m, backend=backend)


def _to_port(js):
    """The port's PosteriorState (on the CPU) from a JAX one, through numpy."""
    p = js.params
    return convert.posterior_state_from_numpy(
        np.asarray(js.lpacked), np.asarray(js.alpha), np.asarray(js.x_chunks), js.n, js.m,
        convert.params_from_numpy(p.lengthscale, p.vertical, p.noise),
        None if js.beta is None else np.asarray(js.beta),
        None if js.y_chunks is None else np.asarray(js.y_chunks),
        device=CPU,
    )


def _spd_factor(rng, n, m):
    a = rng.standard_normal((n, n))
    k = a @ a.T + n * np.eye(n)
    return k, np.asarray(jtil.pack_lower(jnp.asarray(np.linalg.cholesky(k), jnp.float32), m))


def _launches_by_op(plan):
    """Batched launches per op of a plan (the JAX Plan has no such method)."""
    counts = {}
    for level in plan.levels:
        for b in level:
            counts[b.op] = counts.get(b.op, 0) + 1
    return counts


def _plan_digest(plan):
    return [
        [(b.op, tuple(b.tasks), tuple(None if x is None else tuple(int(v) for v in x)
                                      for x in (b.out, b.a, b.b, b.c))) for b in level]
        for level in plan.levels
    ]


# ---------------------------------------------------------------------------
# DAGs, schedules, index maps and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_streams", STREAMS)
@pytest.mark.parametrize("m_tiles", [0, 1, 2, 3, 5, 8])
def test_update_dags_and_schedules_match_reference(m_tiles, n_streams):
    assert tsch.append_tasks(m_tiles) == jsch.append_tasks(m_tiles)
    for t in tsch.append_tasks(m_tiles):
        assert tsch.append_deps(t, m_tiles) == jsch.append_deps(t, m_tiles)
    assert tsch.rank_update_tasks(m_tiles) == jsch.rank_update_tasks(m_tiles)
    for t in tsch.rank_update_tasks(m_tiles):
        assert tsch.rank_update_deps(t, m_tiles) == jsch.rank_update_deps(t, m_tiles)
    kinds = ["update_append"] + (["update_rank"] if m_tiles else [])
    for kind in kinds:
        if n_streams is None:
            ts = tsch.build_update_schedule(m_tiles, kind=kind)
            js = jsch.build_update_schedule(m_tiles, kind=kind)
        else:
            ts = tsch.build_wavefront_schedule(m_tiles, n_streams, kind=kind)
            js = jsch.build_wavefront_schedule(m_tiles, n_streams, kind=kind)
        assert (ts.kind, ts.m_tiles) == (js.kind, js.m_tiles)
        assert [list(w) for w in ts.levels] == [list(w) for w in js.levels]
        assert ts.op_counts() == js.op_counts()
        for level in ts.levels:
            for t in level:
                assert tsch.task_deps(t, ts) == jsch.task_deps(t, js)


def test_update_ops_and_bulk_set_match_reference():
    for op in ("UASM", "UASMD", "UTRSM", "UGEMM", "USYRK", "UPOTRF", "UPREP", "UPROW", "UCARRY"):
        assert getattr(tsch, op) == getattr(jsch, op)
        assert tsch.dispatch_group(getattr(tsch, op)) == jsch.dispatch_group(getattr(jsch, op))
    assert {tsch.UASM, tsch.UASMD} <= tsch.BULK_OPS
    assert tsch.BULK_OPS == jsch.BULK_OPS  # LRGEMM too, since the low-rank slice


@pytest.mark.parametrize("m_tiles", [1, 2, 3, 5, 8])
def test_update_index_maps_match_reference(m_tiles):
    np.testing.assert_array_equal(ttil.grow_packed_indices(m_tiles), jtil.grow_packed_indices(m_tiles))
    for row in range(m_tiles):
        np.testing.assert_array_equal(
            ttil.replace_row_indices(row, m_tiles), jtil.replace_row_indices(row, m_tiles)
        )
    np.testing.assert_array_equal(
        ttil.replace_last_row_indices(m_tiles), jtil.replace_last_row_indices(m_tiles)
    )
    if m_tiles > 1:
        for t_arr, j_arr in zip(ttil.shrink_packed_indices(m_tiles), jtil.shrink_packed_indices(m_tiles)):
            np.testing.assert_array_equal(t_arr, j_arr)


@pytest.mark.parametrize("n_streams", STREAMS)
@pytest.mark.parametrize("m_tiles", [1, 2, 4, 8])
def test_update_plans_match_reference(m_tiles, n_streams):
    for m_store in (m_tiles, m_tiles + 1):  # grow, and refill the last row in place
        tp = tex.update_append_plan(m_tiles, m_store, n_streams)
        jp = jex.update_append_plan(m_tiles, m_store, n_streams)
        assert _plan_digest(tp) == _plan_digest(jp)
        assert tp.launches_by_op() == _launches_by_op(jp)
        assert tp.level_task_counts() == jp.level_task_counts()
    tp, jp = tex.update_rank_plan(m_tiles, n_streams), jex.update_rank_plan(m_tiles, n_streams)
    assert _plan_digest(tp) == _plan_digest(jp)
    assert tp.launches_by_op() == _launches_by_op(jp)
    assert tp.level_task_counts() == jp.level_task_counts()
    assert tex.plan_wave_stats(tp) == jex.plan_wave_stats(jp)


def test_update_plans_of_the_sliding_window_path():
    """gp_16k (32 tiles): the launches one sliding-window step issues."""
    ap = tex.update_append_plan(32, 32, None)
    rp = tex.update_rank_plan(32, None)
    assert len(ap.levels) == 66 and len(rp.levels) == 94
    assert ap.launches_by_op() == {
        tsch.UASM: 1, tsch.UASMD: 1, tsch.UTRSM: 32, tsch.USYRK: 32, tsch.UGEMM: 31, tsch.UPOTRF: 1,
    }
    assert rp.launches_by_op() == {tsch.UPREP: 32, tsch.UPROW: 31, tsch.UCARRY: 31}
    assert [b.size for lvl in rp.levels for b in lvl if b.op == tsch.UCARRY] == list(range(31, 0, -1))


# ---------------------------------------------------------------------------
# the carry kernel's plain version
# ---------------------------------------------------------------------------


def _carry_case(rng, g, m, dtype):
    w, l, y, r = ((rng.standard_normal((g, m, m)) / np.sqrt(m)).astype(dtype) for _ in range(4))
    c = np.linalg.cholesky(np.eye(m, dtype=dtype) + r @ np.swapaxes(r, -1, -2)).astype(dtype)
    return w, l, y, c


@pytest.mark.parametrize("g,m", [(1, 8), (3, 16), (2, 24)])
def test_carry_update_plain_matches_pallas(rng, g, m):
    w, l, y, c = _carry_case(rng, g, m, np.float32)
    want = np.asarray(
        jdown.carry_update_batched(*(jnp.asarray(a) for a in (w, l, y, c)), interpret=True)
    )
    got = carry_update.carry_update_plain(T(w), T(l), T(y), T(c))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("g,m", [(2, 16), (3, 33)])
def test_carry_update_plain_float64_matches_scipy(rng, g, m):
    w, l, y, c = _carry_case(rng, g, m, np.float64)
    want = np.stack([
        scipy.linalg.solve_triangular(c[i], (w[i] - l[i] @ y[i]).T, lower=True).T for i in range(g)
    ])
    got = ops.carry_update(T(w), T(l), T(y), T(c))  # a CPU tensor takes the plain version
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)


def test_cpu_carry_update_counts_no_launch(rng):
    ops.reset_launch_counts()
    ops.carry_update(*(T(a) for a in _carry_case(rng, 2, 8, np.float32)))
    assert ops.launch_counts()["carry_update"] == 0
    with pytest.raises(ValueError):
        carry_update.carry_update_cuda(*(T(a) for a in _carry_case(rng, 2, 8, np.float32)))


# ---------------------------------------------------------------------------
# rank updates of a factor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_update_factor_matches_dense_and_reference(rng, backend):
    n, m, r = 48, 16, 5
    k, lp = _spd_factor(rng, n, m)
    w = np.zeros((n // m, m, m), np.float32)
    wv = rng.standard_normal((n, r)).astype(np.float32) * 0.3
    w[:, :, :r] = wv.reshape(n // m, m, r)
    up = tupd.update_factor(T(lp), T(w), device=CPU)
    dense = np.asarray(jtil.pack_lower(jnp.asarray(np.linalg.cholesky(k + wv @ wv.T), jnp.float32), m))
    np.testing.assert_allclose(up.numpy(), dense, rtol=1e-3, atol=1e-3)
    ref = np.asarray(jupd.update_factor(jnp.asarray(lp), jnp.asarray(w), backend=backend))
    np.testing.assert_allclose(up.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_downdate_then_update_roundtrip(rng):
    n, m, r = 48, 16, 4
    _, lp = _spd_factor(rng, n, m)
    w = np.zeros((n // m, m, m), np.float32)
    w[:, :, :r] = (rng.standard_normal((n, r)) * 0.5).reshape(n // m, m, r)
    lp_t, w_t = T(lp), T(w)
    up = tupd.update_factor(lp_t, w_t, device=CPU)
    back = tupd.downdate_factor(up, w_t, device=CPU)
    np.testing.assert_allclose(back.numpy(), lp, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(lp_t.numpy(), lp)  # the inputs are left as they were
    np.testing.assert_array_equal(w_t.numpy(), w)


def test_nonpd_downdate_raises(rng):
    n, m = 48, 16
    _, lp = _spd_factor(rng, n, m)
    w = rng.standard_normal((n // m, m, m)).astype(np.float32) * 100.0
    with pytest.raises(tupd.CholeskyUpdateError, match="refactorization"):
        tupd.downdate_factor(T(lp), T(w), device=CPU)
    new, _ = tex.run_rank_update(T(lp), T(w), sign=-1.0, device=CPU)
    assert torch.isnan(new).any()  # the POTRF heads go NaN; nothing raises below _check


# ---------------------------------------------------------------------------
# extend / shrink a cached state
# ---------------------------------------------------------------------------


def _extend_grid():
    cells = []
    for n0, b in [(32, 5), (30, 5), (30, 40), (10, 3), (48, 16)]:
        for backend in ("jnp", "pallas"):
            if backend == "jnp" or n0 + b <= 50:
                cells.append(pytest.param(n0, b, backend, id=f"n{n0}-b{b}-{backend}"))
    return cells


@pytest.mark.parametrize("n0,b,backend", _extend_grid())
def test_extend_state_matches_reference(rng, n0, b, backend):
    m = 16
    x, y = _data(rng, n0 + b)
    js = _jax_state(x[:n0], y[:n0], m, backend)
    jgrown = js.extend(x[n0:], y[n0:], backend=backend)
    grown = _to_port(js).extend(x[n0:], y[n0:])
    assert grown.n == jgrown.n == n0 + b
    assert tuple(grown.lpacked.shape) == tuple(jgrown.lpacked.shape)
    np.testing.assert_allclose(grown.lpacked.numpy(), np.asarray(jgrown.lpacked), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grown.alpha.numpy(), np.asarray(jgrown.alpha), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(grown.beta.numpy(), np.asarray(jgrown.beta), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(grown.x_chunks.numpy(), np.asarray(jgrown.x_chunks))
    np.testing.assert_array_equal(grown.y_chunks.numpy(), np.asarray(jgrown.y_chunks))
    xt = rng.standard_normal((7, x.shape[1])).astype(np.float32)
    mu, cov = tpred.predict_from_state(grown, xt, full_cov=True)
    mu_r, cov_r = jpred.predict_from_state(jgrown, jnp.asarray(xt), full_cov=True)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), atol=1e-4)
    np.testing.assert_allclose(cov.numpy(), np.asarray(cov_r), atol=1e-4)


@pytest.mark.parametrize("n_streams", [1, 2])
def test_extend_and_shrink_with_a_stream_pool(rng, n_streams):
    m = 16
    x, y = _data(rng, 56)
    js = _jax_state(x[:40], y[:40], m)
    jnew = js.extend(x[40:], y[40:], n_streams=n_streams).shrink(16, n_streams=n_streams)
    new = _to_port(js).extend(x[40:], y[40:], n_streams=n_streams).shrink(16, n_streams=n_streams)
    np.testing.assert_allclose(new.lpacked.numpy(), np.asarray(jnew.lpacked), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(new.alpha.numpy(), np.asarray(jnew.alpha), rtol=1e-3, atol=1e-4)


def test_extend_state_without_live_fields(rng):
    """A state without beta/y_chunks gets them from the factor."""
    n0, b, m = 32, 7, 16
    x, y = _data(rng, n0 + b)
    js = _jax_state(x[:n0], y[:n0], m)
    full = _to_port(js)
    legacy = tpred.PosteriorState(
        lpacked=full.lpacked, alpha=full.alpha, x_chunks=full.x_chunks, n=full.n, m=full.m,
        params=full.params,
    )
    grown = legacy.extend(x[n0:], y[n0:])
    ref = _jax_state(x, y, m)
    np.testing.assert_allclose(grown.alpha.numpy(), np.asarray(ref.alpha), rtol=1e-3, atol=1e-4)


def test_extend_state_validates(rng):
    x, y = _data(rng, 20)
    state = _to_port(_jax_state(x, y, 16))
    with pytest.raises(ValueError, match="x_new"):
        state.extend(rng.standard_normal((3, 5)).astype(np.float32), np.zeros(3, np.float32))
    assert state.extend(np.zeros((0, 2), np.float32), np.zeros(0, np.float32)) is state


@pytest.mark.parametrize("n,k", [(48, 16), (50, 16), (64, 32)])
def test_shrink_state_matches_reference(rng, n, k):
    m = 16
    x, y = _data(rng, n)
    js = _jax_state(x, y, m)
    jkept = js.shrink(k)
    kept = _to_port(js).shrink(k)
    assert kept.n == jkept.n == n - k
    np.testing.assert_allclose(kept.lpacked.numpy(), np.asarray(jkept.lpacked), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(kept.alpha.numpy(), np.asarray(jkept.alpha), rtol=1e-3, atol=2e-4)
    ref = _jax_state(x[k:], y[k:], m)  # and the from-scratch fit of the kept rows
    np.testing.assert_allclose(kept.lpacked.numpy(), np.asarray(ref.lpacked), rtol=1e-3, atol=1e-4)


def test_shrink_state_validates(rng):
    x, y = _data(rng, 48)
    state = _to_port(_jax_state(x, y, 16))
    with pytest.raises(ValueError, match="multiple"):
        state.shrink(10)
    with pytest.raises(ValueError, match="evict"):
        state.shrink(48)
    assert state.shrink(0) is state


def _snapshot(state):
    return {
        f: getattr(state, f).clone()
        for f in ("lpacked", "alpha", "x_chunks", "beta", "y_chunks")
        if getattr(state, f) is not None
    }


def _assert_unchanged(state, snap):
    for f, t in snap.items():
        assert torch.equal(getattr(state, f), t), f


@pytest.mark.parametrize("n0,b", [(32, 16), (30, 5)])
def test_extend_and_shrink_leave_the_input_state_unchanged(rng, n0, b):
    x, y = _data(rng, n0 + b)
    xt = rng.standard_normal((5, 2)).astype(np.float32)
    # a state that came out of the fused cold path aliases the program's buffers
    gp = GaussianProcess(x[:n0], y[:n0], tile_size=16, device=CPU)
    gp.predict(xt)
    fused = gp._posterior
    snap = _snapshot(fused)
    grown = fused.extend(x[n0:], y[n0:])
    _assert_unchanged(fused, snap)
    snap_grown = _snapshot(grown)
    grown.shrink(16)
    _assert_unchanged(grown, snap_grown)
    # and the staged posterior_state
    staged = tpred.posterior_state(x[:n0], y[:n0], gp.params, 16, device=CPU)
    snap = _snapshot(staged)
    staged.extend(x[n0:], y[n0:]).shrink(16)
    staged.shrink(16)
    _assert_unchanged(staged, snap)


# ---------------------------------------------------------------------------
# the GaussianProcess front end
# ---------------------------------------------------------------------------


def _jax_mean(x, y, xt, **kw):
    return np.asarray(JaxGP(x, y, tile_size=16, **kw).predict(xt))


def test_gp_update_extends_warm_cache(rng, monkeypatch):
    """A warm update extends the cached state: no refactorization."""
    x, y = _data(rng, 50)
    xt = rng.standard_normal((9, 2)).astype(np.float32)
    gp = GaussianProcess(x[:40], y[:40], tile_size=16, device=CPU)
    gp.predict(xt)
    old = gp._posterior
    snap = _snapshot(old)

    def cold(*a, **kw):
        raise AssertionError("update ran a full refactorization")

    monkeypatch.setattr(tpred, "posterior_state", cold)
    monkeypatch.setattr(tpred, "predict_fused", cold)
    gp.update(x[40:], y[40:])
    assert gp._cache_warm(), "warm update must keep the posterior cache"
    assert gp._posterior is not old and gp._posterior.n == 50
    _assert_unchanged(old, snap)
    np.testing.assert_allclose(gp.predict(xt).numpy(), _jax_mean(x, y, xt), atol=1e-4)


def test_gp_update_cold_cache_invalidates(rng):
    x, y = _data(rng, 50)
    xt = rng.standard_normal((5, 2)).astype(np.float32)
    gp = GaussianProcess(x[:40], y[:40], tile_size=16, device=CPU)
    gp.update(x[40:], y[40:])  # nothing cached yet
    assert gp._posterior is None, "cold update must leave the cache cold"
    assert gp.y_train.shape == (50,)
    np.testing.assert_allclose(gp.predict(xt).numpy(), _jax_mean(x, y, xt), atol=1e-5)


def test_gp_update_numerical_fallback(rng, monkeypatch):
    """A failed append invalidates the cache; the next predict refactorizes."""
    x, y = _data(rng, 50)
    xt = rng.standard_normal((5, 2)).astype(np.float32)
    gp = GaussianProcess(x[:40], y[:40], tile_size=16, device=CPU)
    gp.predict(xt)

    def boom(*a, **kw):
        raise tupd.CholeskyUpdateError("synthetic instability")

    monkeypatch.setattr(tupd, "extend_state", boom)
    gp.update(x[40:], y[40:])
    assert gp._posterior is None, "failed append must invalidate the cache"
    monkeypatch.undo()
    np.testing.assert_allclose(gp.predict(xt).numpy(), _jax_mean(x, y, xt), atol=1e-5)


def test_gp_update_validates_shapes(rng):
    x, y = _data(rng, 32)
    gp = GaussianProcess(x, y, tile_size=16, device=CPU)
    with pytest.raises(ValueError, match="update"):
        gp.update(rng.standard_normal((3, 2)).astype(np.float32), np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="sliding_window"):
        GaussianProcess(x, y, tile_size=16, sliding_window=0, device=CPU)
    assert gp.update(np.zeros((0, 2), np.float32), np.zeros(0, np.float32)) is gp


def test_gp_sliding_window(rng):
    """update() with sliding_window evicts the oldest rows, keeping the cache warm."""
    x, y = _data(rng, 48)
    xt = rng.standard_normal((7, 2)).astype(np.float32)
    gp = GaussianProcess(x[:32], y[:32], tile_size=16, sliding_window=32, device=CPU)
    gp.predict(xt)
    gp.update(x[32:48], y[32:48])  # 48 > 32: evict the oldest 16
    assert gp.y_train.shape[0] == 32
    assert gp._cache_warm()
    jgp = JaxGP(x[:32], y[:32], tile_size=16, sliding_window=32)
    jgp.predict(xt)
    jgp.update(x[32:48], y[32:48])
    np.testing.assert_allclose(gp.predict(xt).numpy(), np.asarray(jgp.predict(xt)), atol=1e-4)
    np.testing.assert_allclose(gp.predict(xt).numpy(), _jax_mean(x[16:48], y[16:48], xt), atol=1e-4)


def test_gp_forget_unaligned_falls_back(rng):
    x, y = _data(rng, 40)
    xt = rng.standard_normal((5, 2)).astype(np.float32)
    gp = GaussianProcess(x, y, tile_size=16, device=CPU)
    gp.predict(xt)
    gp.forget(10)  # not tile-aligned: the cache invalidates, the result stays right
    assert gp._posterior is None
    np.testing.assert_allclose(gp.predict(xt).numpy(), _jax_mean(x[10:], y[10:], xt), atol=1e-5)
    with pytest.raises(ValueError, match="forget"):
        gp.forget(30)
    gp.forget(16)  # aligned, on a warm cache: the rank-update sweep
    assert gp._cache_warm()
    np.testing.assert_allclose(gp.predict(xt).numpy(), _jax_mean(x[26:], y[26:], xt), atol=1e-4)


# ---------------------------------------------------------------------------
# check_finite: the updates' one host read, and what skipping it returns
# ---------------------------------------------------------------------------


def _non_finite_case(rng, which):
    """(port call, reference call) of one update entry point on an input that makes its result non-finite."""
    m = 16
    if which in ("update", "downdate"):
        n = 48
        _, lp = _spd_factor(rng, n, m)
        w = rng.standard_normal((n // m, m, m)).astype(np.float32) * 0.1
        w[1, 3, 2] = np.nan
        port, ref = getattr(tupd, f"{which}_factor"), getattr(jupd, f"{which}_factor")
        return (lambda **kw: port(T(lp), T(w), device=CPU, **kw),
                lambda **kw: ref(jnp.asarray(lp), jnp.asarray(w), **kw))
    x, y = _data(rng, 40)
    if which == "extend":
        y[36] = np.nan
        js = _jax_state(x[:32], y[:32], m)
        return (lambda **kw: tupd.extend_state(_to_port(js), x[32:], y[32:], **kw),
                lambda **kw: jupd.extend_state(js, jnp.asarray(x[32:]), jnp.asarray(y[32:]), **kw))
    y[20] = np.nan  # shrink: a NaN in a kept row's target
    js = _jax_state(x, y, m)
    return (lambda **kw: tupd.shrink_state(_to_port(js), 16, **kw),
            lambda **kw: jupd.shrink_state(js, 16, **kw))


def _result_arrays(out):
    if isinstance(out, (torch.Tensor, jnp.ndarray)):
        return [np.asarray(out)]
    return [np.asarray(out.lpacked), np.asarray(out.alpha)]


@pytest.mark.parametrize("which", ["extend", "shrink", "update", "downdate"])
def test_check_finite_raises_or_returns_the_reference_result(rng, which):
    port, ref = _non_finite_case(rng, which)
    with pytest.raises(tupd.CholeskyUpdateError, match="non-finite"):
        port()
    with pytest.raises(jupd.CholeskyUpdateError):
        ref()
    got, want = _result_arrays(port(check_finite=False)), _result_arrays(ref(check_finite=False))
    assert not all(np.isfinite(a).all() for a in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, equal_nan=True)
