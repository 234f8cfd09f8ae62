"""The paper's mass-spring-damper NFIR data, many rollouts at once.

A frozen copy of the physics of ``repro_torch/data/msd.py`` (the chain of
masses, its hardening cubic springs and dampers, the smoothed random force,
the fixed-step RK4 and the NFIR windows), rewritten to integrate R
independent rollouts side by side: every operation of the scalar simulator
is one tensor operation over the rollouts, in the same order, so one rollout
fed the same force draws gives the scalar simulator's positions to float64
rounding.  The scalar simulator integrates one long rollout in a Python loop
(6.6 s at 16384 rows); here a dataset is many short rollouts, each started
at rest and run through a burn-in before its rows are kept, so the number
of sequential steps does not grow with the rows.

Nothing here imports the program: the benchmark owns its data.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# the simulator's constants (repro_torch/data/msd.py: MSDConfig)
PHYSICS = {
    "n_masses": 3,
    "mass": 1.0,
    "spring": 5.0,
    "spring_cubic": 1.0,
    "damper": 1.5,
    "dt": 0.5,
    "substeps": 20,
    "n_regressors": 16,
    "noise_std": 0.05,
    "force_scale": 4.0,
    "force_cutoff": 0.25,
}


def _accel(pos: torch.Tensor, vel: torch.Tensor, u: torch.Tensor, p: Dict) -> torch.Tensor:
    """m q'' of every mass of every rollout: pos, vel (n_masses, R), u (R,)."""
    ext = torch.cat((pos[:1], pos[1:] - pos[:-1]))
    vext = torch.cat((vel[:1], vel[1:] - vel[:-1]))
    f_spring = -(p["spring"] * ext + p["spring_cubic"] * ext**3)
    f_damp = -p["damper"] * vext
    f = f_spring + f_damp
    f[:-1] -= f_spring[1:] + f_damp[1:]
    f[0] += u
    return f / p["mass"]


def integrate(draws: torch.Tensor, p: Dict = PHYSICS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Force and last-mass position of R rollouts from rest.

    ``draws`` (T, R) float64 are the force's normal draws (scale
    ``force_scale``), one a step and rollout.  Returns (u, y), both (T, R):
    the smoothed force and the noiseless position of the last mass.
    """
    t_steps, r = draws.shape
    pos = draws.new_zeros((p["n_masses"], r))
    vel = draws.new_zeros((p["n_masses"], r))
    u = draws.new_zeros((r,))
    u_seq = torch.empty_like(draws)
    y_seq = torch.empty_like(draws)
    h = p["dt"] / p["substeps"]
    hh, h6 = 0.5 * h, h / 6.0
    keep = 1 - p["force_cutoff"]
    for t in range(t_steps):
        u = keep * u + p["force_cutoff"] * draws[t]
        for _ in range(p["substeps"]):
            k1v = _accel(pos, vel, u, p)
            k1x = vel
            k2x = vel + hh * k1v
            k2v = _accel(pos + hh * k1x, k2x, u, p)
            k3x = vel + hh * k2v
            k3v = _accel(pos + hh * k2x, k3x, u, p)
            k4x = vel + h * k3v
            k4v = _accel(pos + h * k3x, k4x, u, p)
            pos = pos + h6 * (k1x + 2 * k2x + 2 * k3x + k4x)
            vel = vel + h6 * (k1v + 2 * k2v + 2 * k3v + k4v)
        u_seq[t] = u
        y_seq[t] = pos[-1]
    return u_seq, y_seq


def windows(u: torch.Tensor, d: int) -> torch.Tensor:
    """NFIR features of (T, R) forces: (R * (T - d + 1), d), most recent input first, rollout-major."""
    w = u.T.unfold(1, d, 1).flip(-1)  # (R, T - d + 1, d)
    return w.reshape(-1, d)


def make_pool(
    seed: int, n_rows: List[int], rows_per_rollout: int, burn_in: int, device, p: Dict = PHYSICS
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], Dict]:
    """Datasets of ``n_rows[i]`` NFIR rows each, from independent rollouts, on ``device`` in float32.

    Every rollout runs ``burn_in`` steps from rest, then ``d - 1`` steps that
    fill the first window, then one step a row.  All rollouts of all datasets
    integrate together.  Inputs and targets are z-scored with the first
    dataset's statistics and the inputs divided by sqrt(2 d), as the scalar
    simulator's ``make_dataset`` scales them, so that l = 1 sees O(1) squared
    distances.  Returns ([(x (n, d), y (n,)), ...], facts).
    """
    d = p["n_regressors"]
    for n in n_rows:
        if n % rows_per_rollout:
            raise ValueError(f"{n} rows are not a whole number of {rows_per_rollout}-row rollouts")
    rollouts = [n // rows_per_rollout for n in n_rows]
    r_total = sum(rollouts)
    t_steps = burn_in + d - 1 + rows_per_rollout
    rng = np.random.default_rng([seed, 0x4D5344])
    draws = rng.normal(0.0, p["force_scale"], size=(t_steps, r_total))
    noise = rng.normal(0.0, p["noise_std"], size=(rows_per_rollout, r_total))
    dev = torch.device(device)
    u, y = integrate(torch.from_numpy(draws).to(dev), p)
    u, y = u[burn_in:], y[burn_in + d - 1:] + torch.from_numpy(noise).to(dev)
    # statistics of the first dataset's kept steps
    r0 = rollouts[0]
    u_mu, u_sd = u[:, :r0].mean(), u[:, :r0].std(unbiased=False) + 1e-12
    y_mu, y_sd = y[:, :r0].mean(), y[:, :r0].std(unbiased=False) + 1e-12
    f_sd = u_sd * math.sqrt(2.0 * d)
    x_all = windows((u - u_mu) / f_sd, d)
    y_all = ((y - y_mu) / y_sd).T.reshape(-1)
    out, row = [], 0
    for n in n_rows:
        out.append((x_all[row:row + n].to(torch.float32).contiguous(), y_all[row:row + n].to(torch.float32).contiguous()))
        row += n
    facts = {"rollouts": r_total, "steps": t_steps, "rk4_substeps": t_steps * p["substeps"]}
    return out, facts
