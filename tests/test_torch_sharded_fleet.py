"""Port parity: fleets whose problem axis is split over a mesh (DESIGN.md §12, ``repro_torch.dist.sharding``).

The cases of ``tests/test_sharded_fleet.py``.  One module-scoped fixture
spawns a 4-rank gloo world on the CPU (``_torch_dist.World``) in which
every rank runs every case (``_torch_dist.sharded_fleet_world``):
``GPBatch`` with B = 4 (split over a 4-rank ``("data",)`` mesh) and B = 6
(no axis divides it: replicated), each with a warm ``update``; the
low-rank ``GPBatch``; ``GPFleet`` (7 sizes in two pow2 buckets, of widths
4 and 3, on a 2x2 ``("data", "model")`` mesh, so one bucket splits and one
replicates) with ``predict_each``, ``nlml`` and an update after which
the first bucket replicates and the second splits, its migrating problem
held by another rank; the low-rank fleet; the step factories; two
``ContinuousBatcher`` waves; and a 1-rank mesh on rank 0.  The same
cases run without a mesh in a fresh 1-rank world (the unsharded port).
While both worlds run, the JAX package runs every case unsharded, in
process, on one device (on three threads).
Rules: every rank's result, and the unsharded port's, within the
reference's 1e-5 of JAX (NLMLs 1e-5 relative); every rank's result
bitwise equal to the unsharded port's; the executor's plan cache the same
in every rank as in the unsharded run.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_dist import (World, batch_data, fleet_data, fleet_lowrank_options, serve_case,
                         sharded_fleet_world, _np)

TOL = 1e-5

BATCH_CASES = {"batch4": ({}, 4), "batch6": ({}, 6), "batch4_lowrank": ({"method": "lowrank", "m_inducing": 16}, 4)}


def _jax_batch(name):
    from repro.core.gp import GPBatch

    kw, b = BATCH_CASES[name]
    x, y, xt, xa, ya = batch_data(b)
    gp = GPBatch(x, y, tile_size=16, **kw)
    out = {"cold": _np(gp.predict_with_uncertainty(xt)), "nlml": _np(gp.nlml())}
    gp.update(xa, ya)
    out["after_update"] = _np(gp.predict(xt))
    return {name: out}


def _jax_fleet(name):
    from repro.core.gp import GPFleet
    from repro.serve.loop import ContinuousBatcher

    xs, ys, xt, tests, xa, ya = fleet_data()
    fleet = GPFleet(xs, ys, tile_size=16, **({} if name == "fleet" else fleet_lowrank_options()))
    out = {"cold": _np(fleet.predict_with_uncertainty(xt)), "each": _np(fleet.predict_each(tests)),
           "nlml": _np(fleet.nlml())}
    fleet.update(xa, ya)
    out["after_update"] = _np(fleet.predict(xt))
    out["buckets"] = fleet.bucket_assignment()
    result = {name: out}
    if name == "fleet":
        result["serve"] = serve_case(fleet, ContinuousBatcher)
    return result


def _jax_steps():
    from repro.core.gp import GPBatch
    from repro.train import make_gp_serve_step, make_gp_train_step

    x, y, xt, _, _ = batch_data(4)
    return {"serve_step": _np(make_gp_serve_step(GPBatch(x, y, tile_size=16), None, uncertainty=True)[0](xt)),
            "train_step": _np(make_gp_train_step(GPBatch(x, y, tile_size=16), None, lr=0.05)[0](steps=2))}


def jax_reference():
    """Every case of ``sharded_fleet_world`` in the JAX package, unsharded, on three threads.

    The JAX fleet compiles many small programs; XLA compiles outside the
    GIL, so the cases overlap (the results are the same as in one thread).
    """
    jobs = [lambda: _jax_fleet("fleet"), lambda: _jax_fleet("fleet_lowrank"), _jax_steps]
    jobs += [functools.partial(_jax_batch, name) for name in BATCH_CASES]
    out = {}
    with ThreadPoolExecutor(3) as pool:
        for part in [pool.submit(job) for job in jobs]:
            out.update(part.result())
    return out


@pytest.fixture(scope="module")
def worlds():
    """(every rank's results, the unsharded port's, JAX's): the worlds run while JAX does."""
    sharded = World(sharded_fleet_world, 4, True, timeout=300)
    # the unsharded port in a fresh process too, so that its plan cache starts as empty as the ranks'
    plain = World(sharded_fleet_world, 1, False, timeout=300)
    try:
        ref = jax_reference()
    except BaseException:
        sharded.kill()
        plain.kill()
        raise
    return sharded.join(), plain.join()[0], ref


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [a for item in v for a in _flat(item)]
    if isinstance(v, dict):
        return [a for k in sorted(v) for a in _flat(v[k])]
    return [np.asarray(v)] if isinstance(v, np.ndarray) else []


def _close(got, want, tol=TOL, bitwise=False, rel=False):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if g.size:
            diff = np.abs(g.astype(np.float64) - w)
            err = float((diff / np.abs(w) if rel else diff).max())
            assert err <= tol, err
            if bitwise:
                np.testing.assert_array_equal(g, w)


RESULTS = ("cold", "nlml", "after_update")
CASES = ["batch4", "batch6", "batch4_lowrank", "fleet", "fleet_lowrank"]


def _keys(case):
    return RESULTS + (("each",) if case.startswith("fleet") else ())


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_unsharded_port(worlds, case):
    sharded, plain, _ = worlds
    for rank in sharded:
        assert rank[case]["warm_after_update"] and plain[case]["warm_after_update"]
        for key in _keys(case):
            _close(rank[case][key], plain[case][key], bitwise=True)


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_jax(worlds, case):
    sharded, plain, ref = worlds
    for result in sharded + [plain]:
        for key in _keys(case):
            _close(result[case][key], ref[case][key], rel=key == "nlml")


def test_unsharded_port_matches_jax(worlds):
    _, plain, ref = worlds
    _close(plain["batch4"]["cold"], ref["batch4"]["cold"])
    nlml, want = plain["batch4"]["nlml"], ref["batch4"]["nlml"]
    assert np.all(np.abs(nlml - want) <= TOL * np.abs(want)), (nlml, want)


def test_each_rank_holds_its_slice(worlds):
    sharded, plain, ref = worlds
    assert [r["batch4"]["local_rows"] for r in sharded] == [1, 1, 1, 1]
    assert [r["batch6"]["local_rows"] for r in sharded] == [6, 6, 6, 6]  # 6 does not divide 4: replicated
    assert plain["batch4"]["local_rows"] == 4
    # after the update the buckets are {4, 5, 6} (replicated) and {0, 1, 2, 3} (split over data = 2)
    assert ref["fleet"]["buckets"] == ref["fleet_lowrank"]["buckets"] == {1: [4, 5, 6], 2: [0, 1, 2, 3]}
    for rank in sharded:
        assert rank["fleet"]["local_widths"] == {1: 3, 2: 2}
        assert rank["fleet_lowrank"]["local_widths"] == {1: 3, 2: 2}


def test_step_factories(worlds):
    sharded, plain, _ = worlds
    for r, rank in enumerate(sharded):
        _close(rank["serve_step"], plain["serve_step"], bitwise=True)
        _close(rank["train_step"], plain["train_step"], bitwise=True)
        assert rank["serve_shardings"] == (f"slice({r}, {r + 1}, None)", ("data",))
    assert plain["serve_shardings"] is None


def test_step_factories_match_jax(worlds):
    sharded, plain, ref = worlds
    for result in sharded + [plain]:
        _close(result["serve_step"], ref["serve_step"])
        _close(result["train_step"], ref["train_step"], rel=True)


def test_batcher_waves(worlds):
    sharded, plain, _ = worlds
    for rank in sharded:
        _close(rank["serve"], plain["serve"], bitwise=True)


def test_batcher_waves_match_jax(worlds):
    sharded, plain, ref = worlds
    for result in sharded + [plain]:
        _close(result["serve"], ref["serve"])


def test_plan_cache_identical_across_world_sizes(worlds):
    sharded, plain, _ = worlds
    assert all(rank["plans"] == plain["plans"] for rank in sharded)


def test_one_rank_mesh(worlds):
    sharded, plain, ref = worlds
    one = sharded[0]["batch4_one"]
    assert one["local_rows"] == 4
    for key in RESULTS:
        _close(one[key], plain["batch4"][key], bitwise=True)
        _close(one[key], ref["batch4"][key], rel=key == "nlml")


def test_mesh_rules_and_refusals(worlds):
    sharded, _, _ = worlds
    for rank in sharded:
        checks = rank["checks"]
        assert checks["fleet_mesh_0"].startswith("ValueError") and checks["fleet_mesh_5"].startswith("ValueError")
        assert checks["fleet_mesh_installed"] and checks["fleet_serve_each"] == [3, 0]
        assert checks["fleet_train"] == "NotImplementedError" and checks["attach_bad"] == "TypeError"
        sh, got, want = checks["single"]
        assert sh is None
        np.testing.assert_array_equal(got, want)  # a single GP ignores the mesh
