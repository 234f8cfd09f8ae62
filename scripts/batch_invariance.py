#!/usr/bin/env python3
"""Does a fleet problem's result depend on how many problems share its launches, and what does it cost not to?

A sharded fleet runs each rank's slice of B through the same programs as
the whole fleet, at narrower launches; its results equal the unsharded
fleet's only where each problem's arithmetic is independent of B.  The
port takes a fleet's tile matvecs and diagonal-tile solves (the executor's
GEMV, GEMV_B, XGEMV and TRSV steps, the solves' products, the warm tails'
matvecs and the append's row solve) through ``ops.tile_gemv`` and
``ops.tile_trsv``, whose CUDA kernels fix every problem's arithmetic by
the tile's shape and strides alone (``csrc/tile_gemv_trsv.cu``).
From the root of a checkout, on a card:

    python3 scripts/batch_invariance.py

prints the card's name and power limit, then one JSON line a route of
those two ops:

* ``kernel``: as the port runs;
* ``per_problem``: their plain versions (one problem at a time);
* ``batched``: one einsum or ``solve_triangular`` over the B problems (one
  cuBLAS batched GEMV or triangular solve, the route before the kernel);

each with the largest difference over 8 shared problems between
fleet_batch's first 16 problems (n = 4096, n̂ = 1024, tile 512, the data of
``chip_smoke.fleet_data``) run as ``GPBatch(B = 16)`` and their first 8 run
as ``GPBatch(B = 8)``, a cold ``predict_with_uncertainty`` and ``nlml``
each; and the seconds of fleet_batch's (B = 16) and fleet_ragged's
(chip_smoke's 32 skewed sizes) cold ``predict_with_uncertainty``, in turns
over the routes, ``REPS`` rounds, host clock around calls that end in
``torch.cuda.synchronize()``, with the number of those ops' calls a cold
call makes.  A last line gives each route's best time over the kernel's.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402  (its fleet data)
from repro_torch.core import GPBatch, GPFleet  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.tile_gemv_trsv import tile_gemv_plain, tile_trsv_plain  # noqa: E402

REPS = 3
KERNEL = {"tile_gemv": ops.tile_gemv, "tile_trsv": ops.tile_trsv}
CALLS = {"n": 0}


def gemv_batched(a, x):
    return torch.einsum("zgqab,zgqb->zga", a, x)


def trsv_batched(l, r, transpose):
    if transpose:
        return torch.linalg.solve_triangular(l.mT, r[..., None], upper=True)[..., 0]
    return torch.linalg.solve_triangular(l, r[..., None], upper=False)[..., 0]


ROUTES = {"kernel": KERNEL, "per_problem": {"tile_gemv": tile_gemv_plain, "tile_trsv": tile_trsv_plain},
          "batched": {"tile_gemv": gemv_batched, "tile_trsv": trsv_batched}}


def counted(fn):
    def call(*args):
        CALLS["n"] += 1
        return fn(*args)
    call.launches = 0  # the kernel route's op bumps the count on the name it is called by
    return call


def use(route: str) -> None:
    for name, fn in ROUTES[route].items():
        setattr(ops, name, counted(fn))


def differences(xb, yb, xtb, dev):
    runs = []
    for b in (16, 8):
        gp = GPBatch(xb[:b], yb[:b], tile_size=512, device=dev)
        mean, var = gp.predict_with_uncertainty(xtb[:b])
        runs.append((mean[:8].cpu(), var[:8].cpu(), gp.nlml()[:8].cpu()))
    return {name: float((a.double() - b.double()).abs().max()) for name, a, b in zip(("mean", "var", "nlml"), *runs)}


def kernel_errors(dev):
    """Each kernel against its plain version (float64) on row-major, transposed and broadcast operands."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for m in (512, 100):
        a = torch.randn(3, 4, 2, m, m, device=dev, generator=gen) / m**0.5
        x = torch.randn(3, 4, 2, m, device=dev, generator=gen)
        xb = torch.randn(3, 1, 2, m, device=dev, generator=gen).expand(3, 4, 2, m)
        for name, (aa, xx) in {"rows": (a, x), "transposed": (a.mT, x), "broadcast": (a, xb)}.items():
            got, want = KERNEL["tile_gemv"](aa, xx), gemv_batched(aa.double(), xx.double())
            out[f"gemv.m{m}.{name}"] = float((got.double() - want).abs().max())
        low = torch.linalg.cholesky(a[:, :, 0] @ a[:, :, 0].mT + torch.eye(m, device=dev))
        for t in (False, True):
            got, want = KERNEL["tile_trsv"](low, x[:, :, 0], t), trsv_batched(low.double(), x[:, :, 0].double(), t)
            out[f"trsv.m{m}.transpose{int(t)}"] = float((got.double() - want).abs().max())
    return out


def cold_seconds(make):
    torch.cuda.synchronize()
    CALLS["n"] = 0
    t0 = time.perf_counter()
    make()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, CALLS["n"]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("batch_invariance.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    xb, yb, xtb, _ = chip_smoke.fleet_data(16, 4096, 1024, chip_smoke.SEED)
    _, xs, ys, shared, _ = chip_smoke.ragged_data()
    calls = {
        "fleet_batch": lambda: GPBatch(xb, yb, tile_size=512, device=dev).predict_with_uncertainty(xtb),
        "fleet_ragged": lambda: GPFleet(xs, ys, tile_size=512, device=dev).predict_with_uncertainty(shared),
    }
    print(json.dumps({"kernel_vs_float64_plain": kernel_errors(dev)}), flush=True)
    try:
        out = {}
        for route in ROUTES:
            use(route)
            out[route] = {"max_abs_diff_b16_vs_b8": differences(xb, yb, xtb, dev)}
            for name, fn in calls.items():  # warm the libraries and the allocator on this route
                fn()
        seconds = {route: {name: [] for name in calls} for route in ROUTES}
        steps = {}
        for _ in range(REPS):
            for route in ("kernel", "per_problem", "batched", "batched", "per_problem", "kernel"):
                use(route)
                for name, fn in calls.items():
                    s, n = cold_seconds(fn)
                    seconds[route][name].append(s)
                    steps[(route, name)] = n
        for route in ROUTES:
            out[route]["cold_seconds"] = seconds[route]
            out[route]["op_calls"] = {name: steps[(route, name)] for name in calls}
        ratio = {route: {name: min(seconds[route][name]) / min(seconds["kernel"][name]) for name in calls}
                 for route in ROUTES}
    finally:
        for name, fn in KERNEL.items():
            setattr(ops, name, fn)
    for route in ROUTES:
        print(json.dumps({"route": route, **out[route]}), flush=True)
    print(json.dumps({"best_of_over_kernel": ratio}), flush=True)


if __name__ == "__main__":
    main()
