"""One run of one cell: set-up, the measured window, the traced window, the metrics and ``correct``.

Everything a cell is made of is found by name: the cell in BENCHMARK.json
names its configuration (``bench/configs/<config>.json``) and its traffic
mix (``bench/traffic/<traffic>.json``); the mix names its call
(``bench/calls/<call>.py``) and the reference that checks it
(``bench/reference/<call>.py``); each metric is read by
``bench/metrics/<name>.py`` and each cell's limits are
``bench/limits/<cell>.json``.  A new configuration, mix, metric or cell is
new files and new entries of BENCHMARK.json.

Every mix is a closed loop with one client: the next request is sent when
the previous one has returned and the device has finished its work.  The
window starts after set-up and ends with the request that crosses
``--seconds``.  The port's telemetry (``obs``) stays off in the measured
and the traced windows, as users run it; it is switched on only for the
mix's ``check_requests`` after them, which show each request cold or warm
as its mix says.  The keys ``source``, ``source_part``, ``guarantees``,
``assumed`` and ``about`` of the data files are prose for the reader.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench import msd, program, trace
from bench import work as yardstick

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that cannot give a result: no card, a missing file, a forbidden import."""


@dataclasses.dataclass
class Ctx:
    cfg: Dict
    mix: Dict
    device: torch.device
    seed: int
    pool: List
    tests: List[torch.Tensor]
    state: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cfg: Dict
    mix: Dict
    device: torch.device
    ctx: Ctx
    setup_s: float
    setup: Dict
    latencies: List[float]
    window_s: float
    requests: int
    units: Dict
    work: Dict
    peaks: Optional[Dict]
    trace: Optional[Dict] = None


def load_json(path: Path) -> Dict:
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    return json.loads(path.read_text())


def find_cell(spec: Dict, name: str):
    """(cell, config file's contents, mix) of the workload called ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def metrics_of(spec: Dict, cell: str, trace_on: bool) -> List[Dict]:
    """The metrics a cell reports: its end-to-end ones untraced, its per-layer ones traced."""
    group = spec["per_layer"] if trace_on else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """``bench/metrics/<name up to the first dot>.py``."""
    mod = name.split(".")[0]
    if not (BENCH / "metrics" / f"{mod}.py").is_file():
        raise Refused(f"no reader for metric {name!r} under bench/metrics/")
    return importlib.import_module(f"bench.metrics.{mod}")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_data(cfg: Dict, mix: Dict, seed: int, device) -> (List, List[torch.Tensor], Dict):
    """The pool of training datasets and the mix's ``test_sets`` test sets, from the seed, on the device."""
    pool_n = cfg["assumed"]["pool"]
    test_rows = cfg["n_test"] if mix["test_rows"] == "n_test" else int(mix["test_rows"])
    n_tests = mix["test_sets"] if test_rows else 0
    sets, facts = msd.make_pool(
        seed, [cfg["n_train"]] * pool_n + [test_rows] * n_tests,
        cfg["assumed"]["rows_per_rollout"], cfg["assumed"]["burn_in_steps"], device,
    )
    tests = [x for x, _ in sets[pool_n:]]
    facts["bytes"] = sum(x.numel() * x.element_size() + y.numel() * y.element_size() for x, y in sets)
    return sets[:pool_n], tests, facts


def window(ctx: Ctx, call, first: int, seconds: float = None, count: int = None):
    """Requests from index ``first`` until one ends past ``seconds`` (or ``count`` of them).

    Returns (latencies, outputs, failures, window seconds).  A request that
    raises, or returns a non-finite number, has failed.
    """
    lat, outs, failed = [], [], []
    sync(ctx.device)
    t_start = time.perf_counter()
    i = first
    while True:
        inp = call.next_input(ctx, i)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("bench.request"):
                out = call.request(ctx, i, inp)
            sync(ctx.device)
        except (RuntimeError, ValueError) as exc:
            failed.append(f"request {i}: {type(exc).__name__}: {exc}"[:300])
            out = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if out is not None:  # a kept view (the variance, a diagonal) would hold its whole base alive
            out = {k: v.clone() if isinstance(v, torch.Tensor) and v._base is not None else v for k, v in out.items()}
        if out is not None and not all(
            bool(torch.isfinite(v).all()) for v in out.values() if isinstance(v, torch.Tensor) and v.is_floating_point()
        ):
            failed.append(f"request {i}: a non-finite output")
        outs.append(out)
        i += 1
        if (count is not None and i - first >= count) or (seconds is not None and t1 - t_start >= seconds):
            return lat, outs, failed, t1 - t_start


def key_of(out: Dict):
    """(training dataset, test set) of a request's outputs."""
    return out["dataset"], out.get("test", 0)


def judge(ctx: Ctx, cell_name: str, outs: List) -> (Dict, Dict, float):
    """The numbers compared with the reference, each beside its limit; every reading of the
    reference module; and the reference's seconds.

    The reference (``bench/reference/<call>.py``) runs in float64 on the
    same inputs, for each (dataset, test set) the outputs came from.
    """
    ref = importlib.import_module(f"bench.reference.{ctx.mix['call']}")
    limits = load_json(BENCH / "limits" / f"{cell_name}.json")
    t0 = time.perf_counter()
    keys = sorted({key_of(o) for o in outs if o is not None})
    pool64 = [(x.double(), y.double()) for x, y in ctx.pool]
    want = ref.expected(pool64, [x.double() for x in ctx.tests], ctx.cfg, ctx.mix, keys)
    got = ref.gaps(ctx.cfg, ctx.mix, [o for o in outs if o is not None], want)
    sync(ctx.device)
    missing = sorted(set(limits) - set(got))
    if missing:
        raise Refused(f"bench/limits/{cell_name}.json limits {missing}, which the reference does not read")
    checks = {name: {"value": got[name], "limit": limit} for name, limit in limits.items()}
    return checks, got, time.perf_counter() - t0


def run_cell(spec: Dict, name: str, seed: int, seconds: float, trace_on: bool, device, t_begin: float,
             log=sys.stderr) -> Dict:
    """One run of cell ``name``; returns the result line's object.  ``t_begin`` is the process's first
    clock reading, before torch was imported."""
    device = torch.device(device)
    _, cfg, mix = find_cell(spec, name)
    if cfg["tf32"]:
        raise Refused("the configuration asks for TF32 products; the port computes float32 with TF32 off only")
    call = importlib.import_module(f"bench.calls.{mix['call']}")
    wanted = metrics_of(spec, name, trace_on)
    readers = {m["name"]: reader(m["name"]) for m in wanted}
    setup = {"import": time.perf_counter() - t_begin}

    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    program.load_libraries(device)
    setup["libraries"] = time.perf_counter() - t
    t = time.perf_counter()
    pool, tests, facts = make_data(cfg, mix, seed, device)
    sync(device)
    setup["data"] = time.perf_counter() - t
    ctx = Ctx(cfg, mix, device, seed, pool, tests)
    t = time.perf_counter()
    call.prepare(ctx)
    call.warmup(ctx)
    sync(device)
    setup["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_begin
    print(json.dumps({"setup_s": setup_s, "setup": setup, "data": facts}), file=log, flush=True)

    lat, outs, failed, window_s = window(ctx, call, 0, seconds=seconds)
    requests = len(lat)
    tr = None
    if trace_on:
        n_tr = mix["trace_requests"]
        first = requests

        def traced_requests(warm):
            nonlocal outs, failed
            if warm:
                call.request(ctx, first, call.next_input(ctx, first))
                sync(device)
                return
            _, o, f, _ = window(ctx, call, first + 1, count=n_tr)
            outs += o
            failed += f

        tr = trace.traced(traced_requests, n_tr)
    first = len(outs) + (1 if trace_on else 0)
    program.counters_on()
    _, o, f, _ = window(ctx, call, first, count=mix["check_requests"])
    counters = program.counters()
    outs += o
    failed += f
    cache_ok, cache_note = call.cache_ok(counters, mix["check_requests"])
    print(json.dumps({"requests": requests, "window_s": window_s, "cache": cache_note,
                      "counters": {k: v for k, v in counters.items() if k.startswith(("cache.", "executor.launches"))}}),
          file=log, flush=True)
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded in the measuring process: {', '.join(found)}")

    mem_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    call.release(ctx)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(cfg, mix, device, ctx, setup_s, setup, lat, window_s, requests, call.units(ctx),
              call.work(cfg, mix), yardstick.peaks_for(kind) if device.type == "cuda" else None, tr)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks, readings, ref_s = judge(ctx, name, outs)
    correct = not failed and cache_ok and all(c["value"] <= c["limit"] for c in checks.values())
    checks["cache_mismatch"] = {"value": 0 if cache_ok else 1, "limit": 0}
    print(json.dumps({"reference_s": ref_s, "readings": readings, "failures": failed[:5],
                      "trace_read_s": None if tr is None else tr["read_s"]}), file=log, flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log, flush=True)

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": mem_peak}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    result = {"correct": bool(correct), "attempted": len(outs), "failed": len(failed),
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result
