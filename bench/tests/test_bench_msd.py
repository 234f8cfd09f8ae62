"""The batched MSD generator against the port's scalar simulator, and its determinism."""

import numpy as np
import torch

from bench import msd
from repro_torch.data.msd import MSDConfig, simulate


def test_physics_is_the_simulators():
    import dataclasses

    assert msd.PHYSICS == dataclasses.asdict(MSDConfig())


def test_one_rollout_matches_the_scalar_rk4_to_float64_rounding():
    n, seed = 400, 2**31 + 7
    u_ref, y_ref = simulate(n, MSDConfig(), seed=seed)
    rng = np.random.default_rng(seed)  # the simulator's draws: n forces, then n noise values
    draws = rng.normal(0.0, 4.0, size=n)
    noise = rng.normal(0.0, 0.05, size=n)
    # the same forces in the middle column of three rollouts: each rollout is independent of the others
    cols = np.stack([np.roll(draws, 5), draws, -draws], axis=1)
    u, y = msd.integrate(torch.from_numpy(cols))
    assert np.abs(u[:, 1].numpy() - u_ref).max() <= 1e-15 * np.abs(u_ref).max()
    assert np.abs(y[:, 1].numpy() + noise - y_ref).max() <= 1e-13 * np.abs(y_ref).max()


def test_windows_are_the_nfir_features():
    from repro_torch.data.msd import nfir_features

    u = torch.arange(40, dtype=torch.float64).reshape(20, 2)
    x = msd.windows(u, 4)
    want, _ = nfir_features(u[:, 0].numpy(), np.zeros(20), 4)
    assert np.array_equal(x[:17].numpy(), want)


def test_pool_is_the_seeds():
    a, facts = msd.make_pool(2**31 + 99, [256, 256, 128], 64, 8, "cpu")
    b, _ = msd.make_pool(2**31 + 99, [256, 256, 128], 64, 8, "cpu")
    c, _ = msd.make_pool(2**31 + 100, [256, 256, 128], 64, 8, "cpu")
    assert [x.shape for x, _ in a] == [(256, 16), (256, 16), (128, 16)]
    assert all(torch.equal(p[0], q[0]) and torch.equal(p[1], q[1]) for p, q in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[0][0], a[1][0])  # the pool's datasets differ
    assert a[0][0].dtype == torch.float32 and abs(float(a[0][1].std(unbiased=False)) - 1.0) < 1e-5
    assert facts == {"rollouts": 10, "steps": 8 + 15 + 64, "rk4_substeps": (8 + 15 + 64) * 20}
