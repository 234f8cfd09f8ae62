"""The paper's end-to-end use case on the PyTorch/CUDA port: system
identification of a coupled mass-spring-damper chain with a tiled,
device-resident GP.

    PYTHONPATH=src python examples_torch/gp_system_identification.py [--n 2048] [--device cpu]

The port picks each tile op's route by the tensor's device (the hand-written
kernels on the card, their plain versions on the CPU), so it has no
``--backend`` switch.
"""

import argparse
import time

import numpy as np

from repro_torch.core import GaussianProcess
from repro_torch.data.msd import MSDConfig, make_dataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import build_kernels


def run(device="cuda", *, n=2048, n_test=512, tile=256, seed=0, data=None, log=print) -> dict:
    """Fit the MSD chain and predict with uncertainty; returns what it prints and the predictions.

    ``data`` is ``(x_train, y_train, x_test, y_test)`` when the caller made it already.
    """
    dev = resolve_device(device)
    cfg = MSDConfig()
    log(f"simulating MSD chain: {cfg.n_masses} masses, D={cfg.n_regressors} regressors")
    x_tr, y_tr, x_te, y_te = make_dataset(n, n_test, cfg, seed=seed) if data is None else data
    build_s = build_kernels(dev)
    if dev.type == "cuda":
        log(f"kernels built and loaded: {build_s:.2f}s")

    gp = GaussianProcess(x_tr, y_tr, tile_size=tile, device=dev)

    t0 = time.perf_counter()
    mean, var = gp.predict_with_uncertainty(x_te)
    synchronize(dev)
    t1 = time.perf_counter()
    mean_np, var_np = mean.cpu().numpy(), var.cpu().numpy()

    mse = float(np.mean((mean_np - y_te) ** 2))
    r2 = 1 - mse / float(np.var(y_te))
    sd = np.sqrt(var_np + float(gp.params.noise))
    cover = float(np.mean(np.abs(mean_np - y_te) < 2 * sd))
    log(f"n={n} tiles/dim={n // tile}  predict+uncertainty wall: {t1 - t0:.2f}s (first call)")
    log(f"r2 = {r2:.3f}   2-sigma coverage = {cover:.2%}")

    # monolithic (cuSOLVER) cross-check
    gp_m = GaussianProcess(x_tr, y_tr, pipeline="monolithic", device=dev)
    mu_m = gp_m.predict(x_te)
    diff = float(np.abs(mean_np - mu_m.cpu().numpy()).max())
    log(f"max |tiled - monolithic| = {diff:.2e}")
    return dict(build_s=build_s, seconds=t1 - t0, r2=r2, coverage=cover, max_tiled_vs_monolithic=diff,
                mean=mean, var=var, mean_monolithic=mu_m, params=gp.params)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048, help="training samples")
    ap.add_argument("--n-test", type=int, default=512)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    run(args.device, n=args.n, n_test=args.n_test, tile=args.tile)


if __name__ == "__main__":
    main()
