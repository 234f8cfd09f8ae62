#!/usr/bin/env python3
"""Does a fleet problem's result depend on how many problems share its launches?  Which plain op makes it so?

A sharded fleet runs each rank's slice of B through the same programs as
the whole fleet, at narrower launches; its results equal the unsharded
fleet's bitwise only where each problem's arithmetic is independent of B.
From the root of a checkout, on a card:

    python3 scripts/batch_invariance.py

runs fleet_batch's first 16 problems (n = 4096, n̂ = 1024, tile 512, the
data of ``chip_smoke.fleet_data``) as ``GPBatch(B = 16)`` and their first 8
as ``GPBatch(B = 8)``, a cold ``predict_with_uncertainty`` and ``nlml``
each, and prints the largest difference over the 8 shared problems, first
as the port runs, then with the batched GEMV/XGEMV contractions
(``torch.einsum`` with the problem axis ``z``) and the diagonal-tile solves
(``executor._trsv_batch``) taken one problem at a time, alone and together.
It prints the card's name and power limit, then one JSON line a variant.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402  (its fleet data)
from repro_torch.core import GPBatch, executor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

EINSUM, TRSV = torch.einsum, executor._trsv_batch


def einsum_each(eq, *operands):
    """A batched contraction (problem axis ``z``) one problem at a time."""
    if eq.startswith("z") and operands[0].shape[0] > 1:
        one = eq.replace("z", "")
        return torch.stack([EINSUM(one, *(o[i] for o in operands)) for i in range(operands[0].shape[0])])
    return EINSUM(eq, *operands)


def trsv_each(lii, x, transpose):
    if lii.ndim == 4:  # (B, G, m, m): a fleet's level
        return torch.stack([TRSV(lii[i], x[i], transpose) for i in range(lii.shape[0])])
    return TRSV(lii, x, transpose)


def differences(xb, yb, xtb, dev, per_problem):
    torch.einsum = einsum_each if "einsum" in per_problem else EINSUM
    executor._trsv_batch = trsv_each if "trsv" in per_problem else TRSV
    try:
        runs = []
        for b in (16, 8):
            gp = GPBatch(xb[:b], yb[:b], tile_size=512, device=dev)
            mean, var = gp.predict_with_uncertainty(xtb[:b])
            runs.append((mean[:8].cpu(), var[:8].cpu(), gp.nlml()[:8].cpu()))
    finally:
        torch.einsum, executor._trsv_batch = EINSUM, TRSV
    return {name: float((a.double() - b.double()).abs().max()) for name, a, b in zip(("mean", "var", "nlml"), *runs)}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("batch_invariance.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    xb, yb, xtb, _ = chip_smoke.fleet_data(16, 4096, 1024, chip_smoke.SEED)
    for per_problem in ((), ("einsum",), ("trsv",), ("einsum", "trsv")):
        out = differences(xb, yb, xtb, dev, per_problem)
        print(json.dumps({"one_problem_at_a_time": list(per_problem), "max_abs_diff_b16_vs_b8": out}), flush=True)


if __name__ == "__main__":
    main()
