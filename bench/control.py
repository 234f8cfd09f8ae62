"""Readings that set a cell's limits: the program's over many seeds, and the control's.

    python3 -m bench.control --workload gp16k.cold --seeds 1-12 --control-seeds 1-3 [--requests 4] [--fault half_batch]

For each seed: the cell's data, ``--requests`` requests through the timed
call (``bench/calls/<call>.py``) and the numbers that ``correct`` compares,
against the float64 reference.  For each control seed: the reference itself
computed in float32 with TF32 products (the next precision below the
configuration's float32 with TF32 off), put in the program's place and read
by the same numbers.  ``--fault`` plants one of ``bench/faults.py``'s
faults under the timed call first, so that the program readings are the
broken program's at the cell's own size.  Prints one JSON line a seed and a
summary: the largest program reading and the smallest control reading of
each number.  A request's clock is not read here; it is not a run of the
benchmark.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

T_BEGIN = time.perf_counter()

from bench import env  # noqa: E402


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def tf32_products(on: bool) -> bool:
    import torch

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    return before


def readings(spec, name, seed, requests, control, device):
    import torch

    from bench import harness

    cell, cfg, mix = harness.find_cell(spec, name)
    call = importlib.import_module(f"bench.calls.{mix['call']}")
    ref = importlib.import_module(f"bench.reference.{mix['call']}")
    pool, tests, _ = harness.make_data(cfg, mix, seed, device)
    ctx = harness.Ctx(cfg, mix, torch.device(device), seed, pool, tests)
    out = {"seed": seed}
    keys = [(k, j) for k in range(len(pool)) for j in range(max(1, len(tests)))]
    if requests:
        call.prepare(ctx)
        outs = [call.request(ctx, i, call.next_input(ctx, i)) for i in range(requests)]
        harness.sync(ctx.device)
        call.release(ctx)
        keys = sorted({harness.key_of(o) for o in outs})
    pool64 = [(x.double(), y.double()) for x, y in pool]
    want = ref.expected(pool64, [x.double() for x in tests], cfg, mix, keys)
    if requests:
        out["program"] = ref.gaps(cfg, mix, outs, want)
    if control:
        before = tf32_products(True)
        try:
            low = ref.expected(pool, tests, cfg, mix, keys)
            out["control"] = ref.gaps(cfg, mix, ref.as_outputs(low, keys), want)
        except RuntimeError as exc:  # a control that crashes has failed and sets no upper reading
            out["control_crashed"] = f"{type(exc).__name__}: {exc}"[:300]
        finally:
            tf32_products(before)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--fault", default=None, help="a fault of bench/faults.py planted under the call")
    args = ap.parse_args(argv)
    env.prepare()

    from bench import faults, harness

    if args.fault:
        faults.plant(args.fault)

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    prog, ctrl = seeds(args.seeds), set(seeds(args.control_seeds))
    worst, least = {}, {}
    for s in sorted(set(prog) | ctrl):
        r = readings(spec, args.workload, s, args.requests if s in prog else 0, s in ctrl, "cuda")
        print(json.dumps(r), flush=True)
        for k, v in r.get("program", {}).items():
            worst[k] = max(worst.get(k, 0.0), v)
        for k, v in r.get("control", {}).items():
            least[k] = min(least.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "program_max": worst, "control_min": least,
                      "seconds": time.perf_counter() - T_BEGIN}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
