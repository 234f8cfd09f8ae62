"""Port parity: ragged fleets (``GPFleet``, the exact tier) against the JAX package.

Four problems of 5, 20, 33 and 60 points in D = 2, tile 16, the sizes of
``tests/test_ragged.py``, in buckets of 2 and 4 tiles (``BOUNDS``; two
buckets keep the reference's compilations few); the arrivals move two
problems from the 2-tile bucket into the 4-tile one.  Inputs are
made with numpy from a seed and handed to both packages; the port runs on
CPU tensors (the kernels' plain versions), the reference with
``op_backend="jnp"``.  Each JAX result is computed once, in a
module-scoped fixture.  Tolerances: float32 means, variances and NLMLs
within 1e-4 of the reference (absolute for O(1) values, relative for the
NLML), warm updates within 1e-4 of a cold rebuild; the index maps
(``embed_packed``, buckets) are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as jgp
from repro.core import kernels_math as jkm
from repro.core import tiling as jtil
from repro_torch import convert
from repro_torch.core import GaussianProcess, GPFleet, SEKernelParams
from repro_torch.core import predict as tpred
from repro_torch.core import tiling as ttil
from repro_torch.core import update as tupd

CPU = "cpu"
M, D, NT = 16, 2, 7
NS = (5, 20, 33, 60)
ARRIVALS = (30, 20, 0, 3)  # 5 -> 35 and 20 -> 40 cross into the 4-tile bucket
BOUNDS = (2, 4)
LS = np.asarray([0.7, 1.0, 1.3, 1.6], np.float32)


def _data(seed=0, ns=NS):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n, D)).astype(np.float32) for n in ns]
    ys = [(np.sin(x.sum(-1)) + 0.1 * rng.standard_normal(len(x))).astype(np.float32) for x in xs]
    return xs, ys


def _tests(seed=5):
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal((NT, D)).astype(np.float32)
    each = [rng.standard_normal((k, D)).astype(np.float32) for k in (3, 0, 7, 2)]
    return shared, each


def _close(got, want, tol, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), 1.0) if rel else 1.0
    assert np.all(np.abs(got - want) <= tol * scale), float(np.max(np.abs(got - want) / scale))


def _port_params():
    return SEKernelParams(torch.from_numpy(LS), 1.1, 0.1)


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference result of this file, computed once."""
    xs, ys = _data()
    shared, each = _tests()
    pj = jkm.SEKernelParams(jnp.asarray(LS), 1.1, 0.1)
    fleet = jgp.GPFleet(xs, ys, params=pj, tile_size=M, boundaries=BOUNDS)
    mean, var = fleet.predict_with_uncertainty(shared)
    out = dict(mean=np.asarray(mean), var=np.asarray(var), nlml=np.asarray(fleet.nlml()),
               assignment=fleet.bucket_assignment())
    out["each"] = [(np.asarray(m), np.asarray(c)) for m, c in fleet.predict_each(each, full_cov=True)]
    out["state"] = fleet._buckets[4].state  # the bucket of problems 2 and 3, warm from the calls above
    xa, ya = _data(seed=3, ns=ARRIVALS)
    fleet.update(xa, ya)
    out["migrated"] = fleet.bucket_assignment()
    out["after_update"] = np.asarray(fleet.predict(shared))
    return out


def test_predict_with_uncertainty_matches_jax(ref):
    xs, ys = _data()
    shared, _ = _tests()
    fleet = GPFleet(xs, ys, params=_port_params(), tile_size=M, boundaries=BOUNDS, device=CPU)
    assert fleet.bucket_assignment() == ref["assignment"] == {2: [0, 1], 4: [2, 3]}
    mean, var = fleet.predict_with_uncertainty(shared)
    _close(mean.numpy(), ref["mean"], 1e-4)
    _close(var.numpy(), ref["var"], 1e-4)
    _close(fleet.nlml().numpy(), ref["nlml"], 1e-4, rel=True)


def test_predict_each_matches_jax(ref):
    xs, ys = _data()
    _, each = _tests()
    fleet = GPFleet(xs, ys, params=_port_params(), tile_size=M, boundaries=BOUNDS, device=CPU)
    got = fleet.predict_each(each, full_cov=True)
    for (gm, gc), (wm, wc), xt in zip(got, ref["each"], each):
        assert gm.shape == (len(xt),) and gc.shape == (len(xt), len(xt))
        _close(gm.numpy(), wm, 1e-4)
        _close(gc.numpy(), wc, 1e-4)
    means = fleet.predict_each(each)
    for m, (wm, _) in zip(means, ref["each"]):
        _close(m.numpy(), wm, 1e-4)


def test_fleet_equals_single_gps():
    """Each problem of the fleet predicts as its own GaussianProcess (masked padding changes nothing)."""
    xs, ys = _data()
    shared, _ = _tests()
    pt = _port_params()
    mean, var = GPFleet(xs, ys, params=pt, tile_size=M, device=CPU).predict_with_uncertainty(shared)
    for i, (x, y) in enumerate(zip(xs, ys)):
        gp = GaussianProcess(x, y, params=SEKernelParams(float(LS[i]), 1.1, 0.1), tile_size=M, device=CPU)
        mi, vi = gp.predict_with_uncertainty(shared)
        _close(mean[i].numpy(), mi.numpy(), 1e-5)
        _close(var[i].numpy(), vi.numpy(), 1e-5)


def test_params_written_in_place_rebuild_the_buckets():
    """A tensor leaf written in place moves the cache key: every bucket rebuilds with the new values."""
    xs, ys = _data()
    shared, _ = _tests()
    fleet = GPFleet(xs, ys, params=SEKernelParams(torch.from_numpy(LS.copy()), 1.1, 0.1), tile_size=M, device=CPU)
    before = fleet.predict(shared)
    fleet.params.lengthscale.mul_(2.0)
    after = fleet.predict(shared)
    cold = GPFleet(xs, ys, params=SEKernelParams(torch.from_numpy(2 * LS), 1.1, 0.1), tile_size=M, device=CPU)
    torch.testing.assert_close(after, cold.predict(shared), rtol=0, atol=0)
    assert not torch.equal(before, after)


def test_update_migrates_buckets_as_jax_does(ref):
    xs, ys = _data()
    shared, _ = _tests()
    xa, ya = _data(seed=3, ns=ARRIVALS)
    fleet = GPFleet(xs, ys, params=_port_params(), tile_size=M, boundaries=BOUNDS, device=CPU)
    fleet.predict(shared)
    fleet.update(xa, ya)
    assert fleet.bucket_assignment() == ref["migrated"] == {4: [0, 1, 2, 3]}
    assert all(b.state is not None for b in fleet._buckets.values())  # every bucket warm: no refactorization
    warm = fleet.predict(shared)
    _close(warm.numpy(), ref["after_update"], 1e-4)
    cold = GPFleet(fleet._xs, fleet._ys, params=_port_params(), tile_size=M, boundaries=BOUNDS, device=CPU)
    _close(warm.numpy(), cold.predict(shared).numpy(), 1e-4)
    assert fleet.update([np.zeros((0, D))] * 4, [np.zeros(0)] * 4) is fleet


@pytest.mark.parametrize("boundaries", ["pow2", 2, (1, 3, 5), (8,)])
def test_bucketing_never_changes_results(boundaries):
    xs, ys = _data()
    shared, _ = _tests()
    base = GPFleet(xs, ys, tile_size=M, device=CPU).predict_with_uncertainty(shared)
    got = GPFleet(xs, ys, tile_size=M, boundaries=boundaries, device=CPU).predict_with_uncertainty(shared)
    for a, b in zip(got, base):
        _close(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("old,new", [(1, 1), (1, 3), (2, 5), (3, 4)])
def test_embed_packed_matches_reference(old, new):
    src, kind = ttil.embed_packed_indices(old, new)
    jsrc, jkind = jtil.embed_packed_indices(old, new)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(kind, jkind)
    rng = np.random.default_rng(old * 10 + new)
    packed = rng.standard_normal((2, ttil.num_packed_tiles(old), 4, 4)).astype(np.float32)
    got = ttil.embed_packed(torch.from_numpy(packed), old, new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtil.embed_packed(jnp.asarray(packed), old, new)))


@pytest.mark.parametrize("spec", ["pow2", 1, 3, (2, 5), (40,)])
@pytest.mark.parametrize("ns", [(1,), (5, 20, 33, 60), (16, 17, 300, 64, 1)])
def test_bucket_problems_matches_reference(spec, ns):
    assert ttil.bucket_boundaries(max(-(-n // M) for n in ns), spec) == jtil.bucket_boundaries(
        max(-(-n // M) for n in ns), spec)
    assert ttil.bucket_problems(ns, M, spec) == jtil.bucket_problems(ns, M, spec)
    with pytest.raises(ValueError, match="at least one"):
        ttil.bucket_problems((3, 0), M)


def test_extend_state_ragged_matches_rebuild():
    """A ragged bucket's warm append against a cold factorization of the grown problems."""
    xs, ys = _data(ns=(20, 33, 40))
    xa, ya = _data(seed=4, ns=(9, 0, 20))
    fleet = GPFleet(xs, ys, tile_size=M, boundaries=(4,), device=CPU)
    state = fleet._bucket_state(4, [0, 1, 2])
    b_max = max(len(y) for y in ya)
    xpad = np.stack([np.pad(x, ((0, b_max - len(x)), (0, 0))) for x in xa])
    ypad = np.stack([np.pad(y, (0, b_max - len(y))) for y in ya])
    grown = tupd.extend_state_ragged(state, xpad, ypad, [9, 0, 20])
    assert grown.n_valid.tolist() == [29, 33, 60]
    rebuilt = GPFleet([np.concatenate([x, a]) for x, a in zip(xs, xa)],
                      [np.concatenate([y, a]) for y, a in zip(ys, ya)], tile_size=M, boundaries=(4,), device=CPU)
    cold = rebuilt._bucket_state(4, [0, 1, 2])
    for field in ("lpacked", "alpha", "beta", "y_chunks", "x_chunks"):
        _close(getattr(grown, field).numpy(), getattr(cold, field).numpy(), 1e-4)
    with pytest.raises(ValueError, match="outgrow"):
        tupd.extend_state_ragged(state, np.zeros((3, 40, D)), np.zeros((3, 40)), [0, 0, 40])
    assert tupd.extend_state_ragged(state, xpad, ypad, [0, 0, 0]) is state


def test_ragged_state_carried_over_from_jax_predicts_the_same(ref):
    """A JAX bucket state (n_valid frontiers, (B,) leaves) crosses over through convert.py."""
    st = ref["state"]
    shared, _ = _tests()
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(st.params)]
    params = convert.kernel_params_from_numpy("se", leaves)
    state = convert.posterior_state_from_numpy(
        st.lpacked, st.alpha, st.x_chunks, st.n, st.m, params, st.beta, st.y_chunks,
        n_valid=np.asarray(st.n_valid), device=CPU,
    )
    assert state.n_valid.tolist() == [33, 60]
    xt = torch.from_numpy(np.broadcast_to(shared, (2,) + shared.shape).copy())
    mean = tpred.predict_from_state_batched(state, xt)
    _close(mean.numpy(), ref["mean"][[2, 3]], 1e-4)


def test_fleet_optimize_fits_each_problem_alone():
    xs, ys = _data()
    fleet = GPFleet(xs, ys, tile_size=M, device=CPU).optimize(steps=2, lr=0.05)
    assert fleet.params.lengthscale.shape == (4,)
    from repro_torch.core import mll

    for i in (0, 3):
        want, _ = mll.optimize_hyperparameters(xs[i], ys[i], SEKernelParams(1.0, 1.0, 0.1), steps=2, lr=0.05,
                                               method="tiled", tile_size=M, device=CPU)
        _close(float(fleet.params.lengthscale[i]), float(want.lengthscale), 1e-6)
    assert not fleet._buckets


def test_fleet_validation_and_unported_options():
    xs, ys = _data()
    with pytest.raises(ValueError, match="requires m_inducing"):
        GPFleet(xs, ys, method="lowrank", device=CPU)
    with pytest.raises(ValueError, match="inducing must be"):
        GPFleet(xs, ys, method="lowrank", m_inducing=4, inducing=np.zeros((3, D)), device=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        GPFleet(xs, ys, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="share D"):
        GPFleet([xs[0], np.zeros((4, 3))], [ys[0], np.zeros(4)], device=CPU)
    with pytest.raises(ValueError, match="per-problem"):
        GPFleet(xs, ys, params=SEKernelParams(torch.ones(3), 1.0, 0.1), device=CPU)
    fleet = GPFleet(xs, ys, tile_size=M, device=CPU)
    with pytest.raises(ValueError, match="predict_each"):
        fleet.predict(np.zeros((2, 3, D)))
    with pytest.raises(ValueError, match="one test set per problem"):
        fleet.predict_each([np.zeros((2, D))])
