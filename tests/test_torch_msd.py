"""Port parity: the paper's mass-spring-damper data (``repro_torch.data.msd``) and GP shapes.

``make_dataset`` at n_train = 512, n_test = 128 against the JAX package's
numpy original (the port integrates on Python floats in the reference's
order of operations, so the two agree to rounding: rtol 1e-9), the
simulator's draws, and the five ``GPShapeConfig`` cells against
``repro.configs.gp_msd``.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import gp_msd as jshapes
from repro.data import msd as jmsd
from repro_torch.configs import gp_msd as tshapes
from repro_torch.data import msd as tmsd


@pytest.mark.parametrize("seed", [0, 3])
def test_make_dataset_matches_reference(seed):
    want = jmsd.make_dataset(512, 128, seed=seed)
    got = tmsd.make_dataset(512, 128, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=0)
    x_train, y_train, _, _ = got
    # z-scored with the statistics of the whole training rollout (n + D - 1 steps), so close to 0 and 1
    assert x_train.shape == (512, 16) and abs(float(y_train.mean())) < 0.05 and abs(float(y_train.std()) - 1) < 0.05


def test_simulate_and_features_match_reference():
    cfg = tmsd.MSDConfig(n_masses=4, substeps=5)
    u, y = tmsd.simulate(200, cfg, seed=7)
    u_ref, y_ref = jmsd.simulate(200, jmsd.MSDConfig(n_masses=4, substeps=5), seed=7)
    np.testing.assert_array_equal(u, u_ref)  # the same draws in the same order
    np.testing.assert_allclose(y, y_ref, rtol=1e-9, atol=1e-12)
    for g, w in zip(tmsd.nfir_features(u, y, 8), jmsd.nfir_features(u_ref, y_ref, 8)):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
    assert dataclasses.asdict(tmsd.MSDConfig()) == dataclasses.asdict(jmsd.MSDConfig())


def test_gp_shapes_match_reference():
    assert [dataclasses.asdict(s) for s in tshapes.ALL_GP_SHAPES] == [
        dataclasses.asdict(s) for s in jshapes.ALL_GP_SHAPES]
    assert [s.m_tiles for s in tshapes.ALL_GP_SHAPES] == [s.m_tiles for s in jshapes.ALL_GP_SHAPES]
    assert tshapes.GP_DIST_32K.m_tiles == 256 and tshapes.GP_DIST_32K.n_test == 16384
