"""Quickstart: tiled GP regression in five lines, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/quickstart.py                 # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu    # the plain versions
"""

import argparse

import numpy as np
import torch

from repro_torch.core import GaussianProcess
from repro_torch.device import resolve_device
from repro_torch.kernels import build_kernels


def make_data(n: int = 256, n_test: int = 100, n_big: int = 8192, seed: int = 0) -> dict:
    """The training set, the test grid and the large set, drawn in the reference's order."""
    rng = np.random.default_rng(seed)
    x_train = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    y_train = np.sin(x_train[:, 0]) + 0.1 * rng.standard_normal(n).astype(np.float32)
    x_test = np.linspace(-3, 3, n_test)[:, None].astype(np.float32)
    x_big = rng.uniform(-3, 3, (n_big, 1)).astype(np.float32)
    y_big = np.sin(x_big[:, 0]) + 0.1 * rng.standard_normal(n_big).astype(np.float32)
    return dict(x_train=x_train, y_train=y_train, x_test=x_test, x_big=x_big, y_big=y_big)


def _mae(mean, x_test) -> float:
    return float(np.abs(mean.cpu().numpy() - np.sin(x_test[:, 0])).mean())


def run(device="cuda", *, n=256, n_test=100, tile=64, steps=50, lr=0.1, n_big=8192, tile_big=256,
        m_inducing=256, seed=0, log=print) -> dict:
    """The reference's quickstart; returns what it prints, with its data, the predictions and the trained params."""
    dev = resolve_device(device)
    d = make_data(n, n_test, n_big, seed)
    out = {"build_s": build_kernels(dev), **d}
    if dev.type == "cuda":
        log(f"kernels built and loaded:       {out['build_s']:.2f}s")
    x_test = d["x_test"]

    # The paper's pipeline: tiled covariance assembly -> tiled Cholesky ->
    # triangular solves -> predictive mean + uncertainty, one device program.
    gp = GaussianProcess(d["x_train"], d["y_train"], tile_size=tile, device=dev)
    mean, var = gp.predict_with_uncertainty(x_test)
    out.update(mean=mean, var=var, mae=_mae(mean, x_test), avg_std=float(torch.sqrt(var).mean()))
    log(f"mean abs error vs ground truth: {out['mae']:.4f}")
    log(f"avg predictive std:             {out['avg_std']:.4f}")

    # hyperparameter optimization (beyond the paper's fixed values)
    gp.optimize(steps=steps, lr=lr)
    mean2, _ = gp.predict_with_uncertainty(x_test)
    out.update(mean_trained=mean2, mae_trained=_mae(mean2, x_test), params=gp.params)
    log(f"after NLML optimization:        {out['mae_trained']:.4f}  params={gp.params}")

    # Large n: method="lowrank" swaps the O(n^3) exact solver for the O(n m^2)
    # Nystrom tier — same API, m_inducing controls the accuracy/speed trade-off.
    gp_lr = GaussianProcess(d["x_big"], d["y_big"], tile_size=tile_big, method="lowrank",
                            m_inducing=m_inducing, device=dev)
    mean_lr = gp_lr.predict(x_test)
    out.update(mean_lowrank=mean_lr, mae_lowrank=_mae(mean_lr, x_test))
    log(f"lowrank (n={n_big}, m={m_inducing}):        {out['mae_lowrank']:.4f}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    run(args.device)


if __name__ == "__main__":
    main()
