#!/usr/bin/env python3
"""A fleet's warm update with the appended row's beta taken two ways, interleaved on one card.

``update._row_beta`` solves beta_R = corner^{-1} (y_R - sum_{j<R} row_j beta_j)
for the row a warm update appends.  For a stacked fleet it takes the tile
products, then the sum over j, and solves on a contiguous corner, so that a
problem's result does not depend on how many problems share the launch
(sharded fleets).  The other way is one einsum over (B, j, m, m) and the
solve on the strided corner, which a single GP keeps.  From the root of a
checkout, on a card:

    python3 scripts/ab_append_row.py [--reps 5]

times ``GPBatch.update`` (fleet_batch: 16 problems of 4096, 512 rows
each) and ``GPFleet.update`` (fleet_ragged: 32 problems, the arrivals of
phase ``fleet.sharded``, two of them migrating), each on a warm posterior,
in the order einsum, tiles, tiles, einsum per repetition.  It prints the
card's name and power limit, then one JSON line: each variant's seconds
by repetition and their medians, and the largest difference between the
two variants' predictions after the update.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402  (its fleet data)
from repro_torch.core import GPBatch, GPFleet, update  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

TILES = update._row_beta


def einsum_beta(row, beta, y_row, r_tiles, batched):
    """The appended row's beta by one einsum over every problem and tile, on the strided corner."""
    s = torch.einsum("...jab,...jb->...a", row[..., :r_tiles, :, :], beta[..., :r_tiles, :])
    corner = row[..., r_tiles, :, :]
    rhs = (y_row - s).to(corner.dtype)[..., None]
    return torch.linalg.solve_triangular(corner, rhs, upper=False)[..., 0]


VARIANTS = {"einsum": einsum_beta, "tiles": TILES}


def timed_update(make, new, xt, variant):
    """(seconds of one warm update, the prediction after it) with ``variant``'s row solve."""
    gp = make()
    gp.predict(xt)
    update._row_beta = VARIANTS[variant]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp.update(*new)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        update._row_beta = TILES
    return seconds, gp.predict(xt)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_append_row.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    n, m = chip_smoke.FLEET_N, chip_smoke.TILE
    xw, yw, xtb, _ = chip_smoke.fleet_data(chip_smoke.FLEET_B, n + m, chip_smoke.FLEET_NT, chip_smoke.SEED)
    (_, _, _, xs, ys, shared, _, xa, ya), _, _ = chip_smoke.fleet_sharded_args()
    cases = {
        "fleet_batch": (lambda: GPBatch(xw[:, :n], yw[:, :n], tile_size=m, device=dev),
                        (xw[:, n:n + m], yw[:, n:n + m]), xtb),
        "fleet_ragged": (lambda: GPFleet(xs, ys, tile_size=m, device=dev), (xa, ya), shared),
    }
    out = {}
    for name, (make, new, xt) in cases.items():
        timed_update(make, new, xt, "tiles")  # warm the programs and the allocator
        seconds = {v: [] for v in VARIANTS}
        preds = {}
        for _ in range(args.reps):
            for v in ("einsum", "tiles", "tiles", "einsum"):
                t, preds[v] = timed_update(make, new, xt, v)
                seconds[v].append(t)
        diff = float((preds["einsum"].double() - preds["tiles"].double()).abs().max())
        out[name] = {"seconds": seconds, "median_s": {v: statistics.median(s) for v, s in seconds.items()},
                     "tiles_over_einsum": statistics.median(seconds["tiles"]) / statistics.median(seconds["einsum"]),
                     "prediction_max_abs_diff": diff}
        torch.cuda.empty_cache()
    print(json.dumps({"ab_append_row": out}), flush=True)


if __name__ == "__main__":
    main()
