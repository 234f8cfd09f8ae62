#!/usr/bin/env python3
"""cov_tiles: this tree's CUDA kernel against an older build of ``csrc/cov_assembly.cu``, interleaved on one card.

The older source is the kernel of commit d52d52c, before the per-problem
table of reals: its C entry point takes the kernel tree's reals as host
doubles and the diagonal value as an argument.  From the root of a checkout:

    git show d52d52c:src/repro_torch/kernels/csrc/cov_assembly.cu > build/cov_old.cu
    python3 scripts/ab_cov_tiles.py build/cov_old.cu

The launch is gp_16k's ASSEMBLE (528 packed tiles of 512 x 512, D = 16,
float32, SE with shared params l = v = 1, noise 0.1).  The script checks that
the two kernels' tiles are bitwise equal, then times, with CUDA events over
20 calls after 2 warm-up calls each, in the order
old, new, ops, ops, new, old, old, new, ops:

* ``old``: the older kernel through its C entry point;
* ``new``: this tree's kernel through its C entry point (``cov_assembly._launch``);
* ``ops``: ``ops.cov_tiles``, the call the executor makes (the wrapper's
  int32 frontier fills included).

It prints the card's name and power limit, then one JSON line.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import kernels_math as km  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.kernels import _build, cov_assembly, ops  # noqa: E402

M_TILES, TILE, D, REPS = 32, 512, 16, 20
ORDER = ("old", "new", "ops", "ops", "new", "old", "old", "new", "ops")


def build_old(source: Path) -> ctypes.CDLL:
    lib_path = ROOT / "build" / "ab_cov_tiles" / "libcov_old.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib_path), str(source)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.cov_tiles_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, p, i, d, i, i, p]
    lib.cov_tiles_f32.restype = i
    return lib


def ms(fn) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage (on a CUDA card): python3 scripts/ab_cov_tiles.py <older cov_assembly.cu>")
    dev = torch.device("cuda", 0)
    old = build_old(Path(sys.argv[1]))
    _build.build_all()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((M_TILES * TILE, D)).astype(np.float32) / 6).to(dev)
    xc = tiling.pad_features(x, TILE)
    rows, cols = (torch.from_numpy(a).to(dev) for a in tiling._packed_coords(M_TILES))
    xa, xb = xc[rows].contiguous(), xc[cols].contiguous()
    t, n = xa.shape[0], M_TILES * TILE
    r0, c0 = (rows * TILE).to(torch.int32), (cols * TILE).to(torch.int32)
    nv = torch.full((t,), n, dtype=torch.int32, device=dev)
    params = km.SEKernelParams(1.0, 1.0, 0.1)
    table = ops.cov_descriptor(None, params, D, torch.float32, dev)
    launch = table.launches[0]
    ints = (ctypes.c_int * len(launch.ints))(*launch.ints)
    # the older descriptor's reals: coef[4] | l[12] | alpha[12] | ard l[64], host doubles
    reals = [1.0] + [0.0] * 3 + [1.0] * 12 + [1.0] * 12 + [1.0] * 64
    reals = (ctypes.c_double * len(reals))(*reals)
    out_old = torch.empty((t, TILE, TILE), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_old():
        code = old.cov_tiles_f32(xa.data_ptr(), xb.data_ptr(), r0.data_ptr(), c0.data_ptr(), nv.data_ptr(),
                                 nv.data_ptr(), out_old.data_ptr(), t, TILE, TILE, D, ints, reals, 0, 1.1, 1, 0, stream)
        if code:
            raise RuntimeError(f"older cov_tiles_f32 returned {code}")

    def run_new():
        return cov_assembly._launch(xa, xb, r0, c0, nv, nv, launch, True)

    def run_ops():
        return ops.cov_tiles(xa, xb, r0, c0, n, n, params, symmetric=True, table=table)

    new = run_new()
    run_old()
    torch.cuda.synchronize()
    result = {"launch": f"{t} tiles of {TILE} x {TILE}, D = {D}, float32, SE", "bitwise_equal": bool(torch.equal(new, out_old)),
              "max_diff": float((new - out_old).abs().max())}
    del new
    fns = {"old": run_old, "new": run_new, "ops": run_ops}
    times = {k: [] for k in fns}
    for name in ORDER:
        times[name].append(ms(fns[name]))
    result.update(times_ms=times, order=ORDER, reps=REPS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps(result))
    if not result["bitwise_equal"]:
        sys.exit("the two kernels' tiles differ")


if __name__ == "__main__":
    main()
