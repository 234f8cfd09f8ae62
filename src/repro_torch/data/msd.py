"""Coupled mass-spring-damper simulator and NFIR dataset (the paper's workload).

A chain of masses coupled by springs and dampers; an input force u(t) drives
the first mass and the observed output y(t) is the position of the last
mass, which depends non-linearly on the force through a hardening cubic
spring term.  The feature vector of an NFIR model is the window of the D
most recent inputs, the target the current output position.

The port's own copy of the JAX package's ``data/msd.py``, with the same
signatures, draws and results.  ``simulate`` integrates the chain with a
fixed-step RK4 on Python floats, in the reference's order of operations
(its numpy arrays hold three masses, so a float loop is several times
faster than array arithmetic); the random draws come in the same order, so
a seed gives the same data.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MSDConfig:
    n_masses: int = 3
    mass: float = 1.0
    spring: float = 5.0          # linear spring constant
    spring_cubic: float = 1.0    # hardening non-linearity (source of non-linear SI)
    damper: float = 1.5
    dt: float = 0.5              # observation rate (constant, as in the paper)
    substeps: int = 20           # RK4 integrator substeps per observation
    n_regressors: int = 16       # D lagged inputs per NFIR feature vector
    noise_std: float = 0.05      # observation noise on y
    force_scale: float = 4.0
    force_cutoff: float = 0.25   # low-pass smoothing factor of the random force


def _accel(pos: List[float], vel: List[float], u: float, cfg: MSDConfig) -> List[float]:
    """Chain dynamics: m q̈_i = spring forces + damping + external force on mass 0."""
    nm = cfg.n_masses
    # spring i connects mass i-1 to mass i (spring 0 to the wall)
    f_spring, f_damp = [0.0] * nm, [0.0] * nm
    for i in range(nm):
        ext = pos[0] if i == 0 else pos[i] - pos[i - 1]
        vext = vel[0] if i == 0 else vel[i] - vel[i - 1]
        f_spring[i] = -(cfg.spring * ext + cfg.spring_cubic * ext**3)
        f_damp[i] = -cfg.damper * vext
    f = [s + d for s, d in zip(f_spring, f_damp)]
    # each spring also pulls the mass above it
    for i in range(nm - 1):
        f[i] -= f_spring[i + 1] + f_damp[i + 1]
    f[0] += u
    return [fi / cfg.mass for fi in f]


def _axpy(x: List[float], a: float, y: List[float]) -> List[float]:
    """x + a * y elementwise (``a`` already the product of the scalars, as numpy forms it)."""
    return [xi + a * yi for xi, yi in zip(x, y)]


def simulate(
    n_steps: int, cfg: MSDConfig = MSDConfig(), seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the chain under a smoothed random force.

    Returns (u, y): input force and output position of the last mass, both
    (n_steps,) float64 observed at rate 1/dt.
    """
    rng = np.random.default_rng(seed)
    pos = [0.0] * cfg.n_masses
    vel = [0.0] * cfg.n_masses
    u_seq = np.empty(n_steps)
    y_seq = np.empty(n_steps)
    u = 0.0
    h = cfg.dt / cfg.substeps
    hh, h6 = 0.5 * h, h / 6.0
    for t in range(n_steps):
        # smoothed random walk force (band-limited excitation)
        u = (1 - cfg.force_cutoff) * u + cfg.force_cutoff * float(rng.normal(0.0, cfg.force_scale))
        for _ in range(cfg.substeps):
            # RK4 on (pos, vel) with constant u over the substep
            k1v = _accel(pos, vel, u, cfg)
            k1x = vel
            k2v = _accel(_axpy(pos, hh, k1x), _axpy(vel, hh, k1v), u, cfg)
            k2x = _axpy(vel, hh, k1v)
            k3v = _accel(_axpy(pos, hh, k2x), _axpy(vel, hh, k2v), u, cfg)
            k3x = _axpy(vel, hh, k2v)
            k4v = _accel(_axpy(pos, h, k3x), _axpy(vel, h, k3v), u, cfg)
            k4x = _axpy(vel, h, k3v)
            pos = [p + h6 * (a + 2 * b + 2 * c + d) for p, a, b, c, d in zip(pos, k1x, k2x, k3x, k4x)]
            vel = [v + h6 * (a + 2 * b + 2 * c + d) for v, a, b, c, d in zip(vel, k1v, k2v, k3v, k4v)]
        u_seq[t] = u
        y_seq[t] = pos[-1]
    y_seq = y_seq + rng.normal(0.0, cfg.noise_std, size=n_steps)
    return u_seq, y_seq


def nfir_features(
    u: np.ndarray, y: np.ndarray, n_regressors: int
) -> Tuple[np.ndarray, np.ndarray]:
    """NFIR feature matrix: x_t = [u_t, u_{t-1}, ..., u_{t-D+1}], target y_t."""
    n = len(u) - n_regressors + 1
    idx = np.arange(n)[:, None] + np.arange(n_regressors)[None, :]
    x = u[idx][:, ::-1]                       # most recent input first
    return np.ascontiguousarray(x), y[n_regressors - 1 :].copy()


def make_dataset(
    n_train: int,
    n_test: int,
    cfg: MSDConfig = MSDConfig(),
    seed: int = 0,
    dtype=np.float32,
    normalize: bool = True,
):
    """Train/test NFIR datasets from independent simulator rollouts.

    ``normalize`` z-scores inputs and targets with training statistics, so
    the paper's fixed hyperparameters (l = 1, v = 1, σ² = 0.1) see a sensible
    regime whatever the system's scale.
    """
    d = cfg.n_regressors
    u_tr, y_tr = simulate(n_train + d - 1, cfg, seed=seed)
    u_te, y_te = simulate(n_test + d - 1, cfg, seed=seed + 1)
    if normalize:
        u_mu, u_sd = u_tr.mean(), u_tr.std() + 1e-12
        y_mu, y_sd = y_tr.mean(), y_tr.std() + 1e-12
        # feature scale: with D z-scored lags E|x - x'|^2 = 2D; rescale so
        # the fixed lengthscale l = 1 sees O(1) squared distances
        f_sd = u_sd * np.sqrt(2.0 * d)
        u_tr, u_te = (u_tr - u_mu) / f_sd, (u_te - u_mu) / f_sd
        y_tr, y_te = (y_tr - y_mu) / y_sd, (y_te - y_mu) / y_sd
    x_train, yy_train = nfir_features(u_tr, y_tr, d)
    x_test, yy_test = nfir_features(u_te, y_te, d)
    return (
        x_train.astype(dtype),
        yy_train.astype(dtype),
        x_test.astype(dtype),
        yy_test.astype(dtype),
    )
