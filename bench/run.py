"""Run one cell of BENCHMARK.json on the card and print its result as the last line of stdout.

    python3 -m bench.run --workload gp16k.cold --seed 7 --seconds 30 --trace 0

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (after the same untraced
window, a traced window of the mix's ``trace_requests``).  Every run checks
its outputs against the plain reference and prints each number compared
beside its limit, last on stderr and under ``checks`` in the result line.
Exits non-zero, printing no result, without a CUDA card, with fewer cards
than the cell asks for, without the port's sources beside the benchmark, or
when JAX or the JAX package was loaded.
"""

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from bench import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.prepare()

    import torch

    from bench import harness

    try:
        if not (env.ROOT / "src" / "repro_torch").is_dir():
            raise harness.Refused("the port (src/repro_torch) is not beside the benchmark")
        spec = harness.load_json(env.ROOT / "BENCHMARK.json")
        cell = harness.find_cell(spec, args.workload)[0]
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise harness.Refused(
                f"the cell needs {cell['chips']} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            )
        result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_BEGIN)
        found = harness.forbidden_modules()
        if found:
            raise harness.Refused(f"loaded in the measuring process: {', '.join(found)}")
    except harness.Refused as exc:
        print(f"bench.run: {exc}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
