#!/usr/bin/env python3
"""tile_gemv / tile_trsv: this tree against another checkout, kernel by kernel and end to end, on one card.

From the root of a checkout, with the older tree unpacked in a git-ignored
directory beside it:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/ab_tile_vector.py build/parent [log file]

One child process a measurement, in the order parent, this, this, parent.
A child puts its tree's ``src`` first on ``sys.path`` (so it builds and runs
that tree's package and kernels) and takes its data and helpers from this
tree's ``chip_smoke.py``, at fleet_batch's sizes (``chip_smoke.FLEET_*``):

* ``kernels``: XGEMV (16, 2, 8, 512, 512), GEMV_B (16, 7, 1, 512, 512) read
  transposed, the forward and the transposed solve (16, 1, 512, 512), device
  ms by CUDA events over 20 calls, beside the batched einsum and
  ``solve_triangular``;
* ``profile.fleet``: one cold ``GPBatch.predict_with_uncertainty`` under
  ``torch.profiler``: device ms of the GEMV and TRSV kernels (by name), busy
  and wall ms; then three unprofiled cold calls (host clock);
* ``update``: fleet.update's window step (``update`` of 512 rows a problem on
  a warm GPBatch), three fresh fleets, and one under the profiler;
* ``serve``: serve.fleet's exact waves/s (``chip_smoke.serve_run`` over
  fleet_ragged's exact fleet).

The card's name and power limit come first; every child's lines go to the
log file (default ``build/ab_tile_vector.log``); the last line is the
summary (JSON).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("parent", "this", "this", "parent")


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.core import GPBatch, GPFleet
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import tile_gemv_trsv as tv

    assert Path(tv.__file__).resolve().is_relative_to(tree.resolve()), tv.__file__
    t0 = time.perf_counter()
    _build.build_all()
    out = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    b, q_tiles, m_tiles, m = cs.FLEET_B, cs.FLEET_NT // cs.TILE, cs.FLEET_N // cs.TILE, cs.TILE
    rows = torch.randn(b, q_tiles, m_tiles, m, m, device=dev, generator=gen) / m
    xb = torch.randn(b, m_tiles, m, device=dev, generator=gen)[:, None].expand(-1, q_tiles, -1, -1)
    cols = (torch.randn(b, m_tiles - 1, m, m, device=dev, generator=gen) / m).mT[:, :, None]
    xc = torch.randn(b, m_tiles - 1, 1, m, device=dev, generator=gen)
    a = torch.randn(b, 1, m, m, device=dev, generator=gen) / m**0.5
    low = torch.linalg.cholesky(a @ a.mT + torch.eye(m, device=dev)).contiguous()
    rhs = torch.randn(b, 1, m, device=dev, generator=gen)
    kernels = {}
    for name, fn, lib in (
            ("xgemv", lambda: ops.tile_gemv(rows, xb), lambda: torch.einsum("zgqab,zgqb->zga", rows, xb)),
            ("gemv_b", lambda: ops.tile_gemv(cols, xc), lambda: torch.einsum("zgqab,zgqb->zga", cols, xc)),
            ("trsv", lambda: ops.tile_trsv(low, rhs, False),
             lambda: torch.linalg.solve_triangular(low, rhs[..., None], upper=False)),
            ("trsv_t", lambda: ops.tile_trsv(low, rhs, True),
             lambda: torch.linalg.solve_triangular(low.mT, rhs[..., None], upper=True))):
        kernels[name] = {"ms": cs.cuda_ms(fn, 20), "library_ms": cs.cuda_ms(lib, 20)}
    out["kernels"] = kernels
    del rows, xb, cols, xc, a, low, rhs
    torch.cuda.empty_cache()

    def split(prof_rows):
        by = {"tile_gemv": 0.0, "tile_trsv": 0.0}
        for k, _, ms in prof_rows:
            if k.startswith(cs.PORT_KERNEL_PREFIX):
                by["tile_gemv"] += ms if "gemv_" in k else 0.0
                by["tile_trsv"] += ms if "trsv_" in k else 0.0
        return by

    xbt, ybt, xtb, _ = cs.fleet_data(b, cs.FLEET_N, cs.FLEET_NT, cs.SEED)
    GPBatch(xbt[:, :1024], ybt[:, :1024], tile_size=cs.TILE, device=dev).predict_with_uncertainty(xtb)  # warm up
    batch = GPBatch(xbt, ybt, tile_size=cs.TILE, device=dev)
    prof_rows, busy, wall = cs.profile_call("ab.profile.fleet", "GPBatch.predict_with_uncertainty (cold)",
                                            lambda: batch.predict_with_uncertainty(xtb))
    del batch
    cold = [cs.wall_s(lambda: GPBatch(xbt, ybt, tile_size=cs.TILE, device=dev).predict_with_uncertainty(xtb))[1]
            for _ in range(3)]
    out["profile_fleet"] = {"device_ms": split(prof_rows), "busy_ms": busy, "wall_ms": wall, "cold_call_s": cold}
    torch.cuda.empty_cache()

    xw, yw, _, _ = cs.fleet_data(b, cs.FLEET_N + cs.TILE, cs.FLEET_NT, cs.SEED)
    n, tile = cs.FLEET_N, cs.TILE
    steps = []
    for _ in range(3):
        fleet = GPBatch(xw[:, :n], yw[:, :n], tile_size=tile, device=dev)
        fleet.predict(xtb)
        steps.append(cs.wall_s(lambda: fleet.update(xw[:, n:n + tile], yw[:, n:n + tile]))[1])
    fleet = GPBatch(xw[:, :n], yw[:, :n], tile_size=tile, device=dev)
    fleet.predict(xtb)
    prof_rows, busy, wall = cs.profile_call("ab.profile.fleet.update", "GPBatch.update(512 rows a problem)",
                                            lambda: fleet.update(xw[:, n:n + tile], yw[:, n:n + tile]))
    out["update"] = {"step_s": steps, "device_ms": split(prof_rows), "busy_ms": busy, "wall_ms": wall}
    del fleet
    torch.cuda.empty_cache()

    _, xs, ys, shared, _ = cs.ragged_data()
    ragged = GPFleet(xs, ys, tile_size=tile, device=dev)
    ragged.predict(shared)
    _, res = cs.serve_run("exact", ragged, cs.serve_traffic(cs.RAGGED_B, cs.SEED + 400, drift=False), dev)
    out["serve"] = {"exact_waves_per_s": res["waves_per_s"], "mismatched_results": res["mismatched_results"],
                    "latency_ms": res["latency_ms"]}
    del ragged
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print("AB " + json.dumps(child(Path(sys.argv[2]))), flush=True)
        return
    if len(sys.argv) not in (2, 3):
        sys.exit("usage (on a CUDA card): python3 scripts/ab_tile_vector.py <older checkout> [log file]")
    parent = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    log_path = Path(sys.argv[2]) if len(sys.argv) == 3 else ROOT / "build" / "ab_tile_vector.log"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    runs = {"parent": [], "this": []}
    with open(log_path, "w") as log:
        for which in ORDER:
            tree = parent if which == "parent" else ROOT
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", str(tree)],
                                  capture_output=True, text=True, env={**os.environ, "PYTHONHASHSEED": "0"})
            log.write(f"=== {which} ({tree}) rc={proc.returncode}\n{proc.stdout}\n{proc.stderr}\n")
            log.flush()
            lines = [line for line in proc.stdout.splitlines() if line.startswith("AB ")]
            if proc.returncode != 0 or not lines:
                print(proc.stderr[-4000:], file=sys.stderr)
                sys.exit(f"ab_tile_vector: the {which} child failed (rc {proc.returncode})")
            runs[which].append(json.loads(lines[-1][3:]))
            print(json.dumps({"run": which, **runs[which][-1]}), flush=True)
    print(json.dumps({"order": ORDER, "runs": runs}))


if __name__ == "__main__":
    main()
