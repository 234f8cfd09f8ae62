"""GP prediction serving on the PyTorch/CUDA port: factor once, serve batched prediction requests.

The paper's workload is inference (predict + uncertainty); the serving shape
is: a trained GP (assembled + factored covariance, device-resident) answering
batches of prediction requests at low latency.

Built on the fused-program `GaussianProcess` API: the offline phase is one
cold fused predict (ONE multi-stage program that also fills the posterior
cache), and the online loop is the warm tail (`predict_from_state` — cross
covariance + mean off the cached factor).  On the card every timed region
ends in `torch.cuda.synchronize()`, and the kernels are built and loaded
before the offline phase, on a line of their own.

``--fleet B`` serves B independent GPs through `GPBatch`: one
problem-batched program factors the whole fleet, and each online batch
answers B × batch requests in a single launch sequence — compare its req/s
against the single-GP numbers to see the wavefront-width win.

``--ragged B`` serves B GPs of *different* sizes through `GPFleet` + the
continuous-batching loop: problems are bucketed by tile geometry, each wave
drains a mixed queue of prediction and observation requests (one ragged
fused launch sequence per occupied bucket), and buckets are re-formed
between waves as problems grow and migrate.

``--online`` turns the server into a *streaming* one: prediction requests
interleave with observation arrivals, absorbed by `GaussianProcess.update` —
the O(n^2 b) block Cholesky append — under a `sliding_window` cap that
evicts the oldest tile when the window overflows.  It reports the served
latency alongside update-vs-full-refactorization latency, the number the
streaming subsystem exists to shrink.

    PYTHONPATH=src python examples_torch/serve_gp.py [--n 4096] [--batches 32]
    PYTHONPATH=src python examples_torch/serve_gp.py --fleet 8 --n 512
    PYTHONPATH=src python examples_torch/serve_gp.py --online --n 1024 --arrive 32
    PYTHONPATH=src python examples_torch/serve_gp.py --ragged 12 --n 512 --tile 64

``--metrics out.jsonl`` enables `repro_torch.obs` telemetry for the run and
streams every event — `serve.wave` records, factorization-health
incidents, a final plan-cache snapshot — to a JSON-lines file:

    PYTHONPATH=src python examples_torch/serve_gp.py --ragged 8 --metrics metrics.jsonl

``--device cpu`` runs the plain versions; the default ``cuda`` raises
without a card.
"""

import argparse
import time

import numpy as np

import repro_torch.obs as obs
from repro_torch.core import GaussianProcess, GPBatch, GPFleet
from repro_torch.core import predict as pred
from repro_torch.core.gp import ieee_float32_matmul
from repro_torch.data.msd import MSDConfig, make_dataset, nfir_features, simulate
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import build_kernels
from repro_torch.serve import ContinuousBatcher


def request_batches(cfg, batch, batches, seed0=100):
    """Fresh NFIR feature batches simulating online prediction requests."""
    for i in range(batches):
        u, y = simulate(batch + cfg.n_regressors - 1, cfg, seed=seed0 + i)
        xt, _ = nfir_features(u, y, cfg.n_regressors)
        yield xt.astype(np.float32)


def report(label, lat, requests, log=print) -> dict:
    lat = np.asarray(lat[1:]) * 1e3  # drop the first batch: its first launches and the kernels' load
    out = dict(p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
               req_per_s=float(requests / np.median(lat) * 1e3))
    log(f"{label}: p50={out['p50_ms']:.2f}ms p99={out['p99_ms']:.2f}ms ({out['req_per_s']:.0f} req/s)")
    return out


def _timed(fn, dev):
    """(result, seconds) of ``fn``, the card's work included."""
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def serve_single(cfg, dev, *, n=4096, tile=512, batch=256, batches=32, log=print) -> dict:
    x_tr, y_tr, _, _ = make_dataset(n, 1, cfg, seed=0)

    # ---- offline: ONE cold fused predict factors + caches the posterior ---
    warm_probe = next(request_batches(cfg, batch, 1))
    gp, offline_s = _timed(lambda: GaussianProcess(x_tr, y_tr, tile_size=tile, device=dev), dev)
    _, t = _timed(lambda: gp.predict(warm_probe), dev)
    offline_s += t
    log(f"fused factor+cache (offline): {offline_s:.2f}s for n={n}")

    # ---- online: the warm tail off the cached PosteriorState --------------
    state = gp.posterior()
    lat, first = [], None
    with ieee_float32_matmul(dev):
        for xt in request_batches(cfg, batch, batches):
            out, t = _timed(lambda: pred.predict_from_state(state, xt), dev)
            lat.append(t)
            if first is None:
                first = (xt, out)
    rep = report(f"served {batches} batches x {batch} requests", lat, batch, log)
    return dict(offline_s=offline_s, latencies_s=lat, **rep, gp=gp, probe=first[0], served=first[1])


def serve_fleet(cfg, dev, *, b=8, n=4096, tile=512, batch=256, batches=32, log=print) -> dict:
    xs, ys = [], []
    for i in range(b):
        x_tr, y_tr, _, _ = make_dataset(n, 1, cfg, seed=i)
        xs.append(x_tr)
        ys.append(y_tr)
    x_stack = np.stack(xs)
    y_stack = np.stack(ys)

    # ---- offline: ONE problem-batched program factors the whole fleet -----
    warm_probe = next(request_batches(cfg, batch, 1))
    fleet, offline_s = _timed(lambda: GPBatch(x_stack, y_stack, tile_size=tile, device=dev), dev)
    _, t = _timed(lambda: fleet.predict(warm_probe), dev)  # shared block broadcast
    offline_s += t
    log(f"fleet fused factor+cache (offline): {offline_s:.2f}s for B={b} x n={n}")

    # ---- online: every request batch is answered for ALL B GPs at once ----
    state = fleet.posterior()
    lat, first = [], None
    with ieee_float32_matmul(dev):
        for xt in request_batches(cfg, batch, batches):
            stacked = np.ascontiguousarray(np.broadcast_to(xt, (b,) + xt.shape))
            out, t = _timed(lambda: pred.predict_from_state_batched(state, stacked), dev)
            lat.append(t)
            if first is None:
                first = (xt, out)
    rep = report(f"served {batches} batches x {batch} requests x B={b} GPs", lat, batch * b, log)
    return dict(offline_s=offline_s, latencies_s=lat, **rep, fleet=fleet, probe=first[0], served=first[1])


def serve_ragged(cfg, dev, *, b=12, n=4096, tile=512, batch=256, batches=32, arrive=32, log=print) -> dict:
    """Continuous batching over a ragged fleet.

    B problems with a skewed size mix (most small, a heavy tail up to n)
    share bucketed fused programs; every wave mixes prediction requests with
    observation arrivals, so problems grow — and migrate buckets — live.
    The last wave's prediction results come back with the fleet."""
    rng = np.random.default_rng(7)
    # skewed mix: sizes log-uniform in [tile/2, n] — many small, few large
    lo, hi = max(tile // 2, 8), max(n, tile)
    ns = np.exp(rng.uniform(np.log(lo), np.log(hi), b)).astype(int)
    xs, ys = [], []
    for i, n_i in enumerate(ns):
        x_tr, y_tr, _, _ = make_dataset(int(n_i), 1, cfg, seed=i)
        xs.append(x_tr)
        ys.append(y_tr)

    warm_probe = next(request_batches(cfg, batch, 1))
    t0 = time.perf_counter()
    fleet = GPFleet(xs, ys, tile_size=tile, device=dev)
    srv = ContinuousBatcher(fleet)
    fleet.predict(warm_probe)  # factor every bucket
    synchronize(dev)
    offline_s = time.perf_counter() - t0
    buckets_before = {c: len(i) for c, i in fleet.bucket_assignment().items()}
    log(f"ragged fleet factor+cache (offline): {offline_s:.2f}s "
        f"for B={b}, sizes {int(ns.min())}..{int(ns.max())}, buckets {buckets_before}")

    migrations, last = 0, {}
    for w, xt in enumerate(request_batches(cfg, batch, batches)):
        # every wave: each problem gets a slice of the request batch ...
        last = {}
        splits = np.array_split(np.arange(xt.shape[0]), b)
        for i, rows in enumerate(splits):
            if rows.size:
                last[i] = (xt[rows], srv.submit_predict(i, xt[rows]))
        # ... and a few problems receive labelled arrivals
        for i in rng.choice(b, size=max(b // 4, 1), replace=False):
            u, yv = simulate(arrive + cfg.n_regressors - 1, cfg, seed=5000 + 97 * w + i)
            x_new, y_new = nfir_features(u, yv, cfg.n_regressors)
            srv.submit_observe(int(i), x_new.astype(np.float32), y_new.astype(np.float32))
        stats = srv.step()
        migrations += stats.migrations
    srv.flush()  # fetch the last wave's one-wave-late dispatched results
    s = srv.summary()
    log(f"ragged: served {int(s['requests'])} requests in {int(s['waves'])} waves "
        f"(p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms, {s['req_per_s']:.0f} req/s)")
    buckets = {c: len(i) for c, i in fleet.bucket_assignment().items()}
    log(f"ragged: {migrations} bucket migrations, final sizes "
        f"{min(fleet.sizes)}..{max(fleet.sizes)}, buckets {buckets}")
    return dict(offline_s=offline_s, requests=int(s["requests"]), waves=int(s["waves"]), p50_ms=s["p50_ms"],
                p99_ms=s["p99_ms"], req_per_s=s["req_per_s"], migrations=migrations, sizes=list(fleet.sizes),
                buckets_before=buckets_before, buckets=buckets, fleet=fleet,
                probe={i: x for i, (x, _) in last.items()},
                served={i: srv.result(rid) for i, (_, rid) in last.items()})


def serve_online(cfg, dev, *, n=4096, tile=512, batch=256, batches=32, arrive=32, log=print) -> dict:
    """Streaming serving: requests interleave with observation arrivals."""
    x_tr, y_tr, _, _ = make_dataset(n, 1, cfg, seed=0)

    gp = GaussianProcess(x_tr, y_tr, tile_size=tile, sliding_window=n, device=dev)
    warm_probe = next(request_batches(cfg, batch, 1))
    _, offline_s = _timed(lambda: gp.predict(warm_probe), dev)
    log(f"fused factor+cache (offline): {offline_s:.2f}s for n={n}")

    # one full refit of the same window (the fused q_tiles=0 program — the
    # honest O(n^3) baseline), run once before it is timed
    def refit():
        with ieee_float32_matmul(dev):
            env, _ = pred.nlml_program_env(gp.x_train, gp.y_train, gp.params, tile, kernel=gp.kernel,
                                           device=dev)
        return env["alpha"]

    _timed(refit, dev)
    _, t_refit = _timed(refit, dev)

    serve_lat, upd_lat, last = [], [], None
    for i, xt in enumerate(request_batches(cfg, batch, batches)):
        last, t = _timed(lambda: gp.predict(xt), dev)
        serve_lat.append(t)
        # observation arrivals: the request batch's first rows come back
        # labelled; absorb them under the sliding window
        u, yv = simulate(arrive + cfg.n_regressors - 1, cfg, seed=1000 + i)
        x_new, y_new = nfir_features(u, yv, cfg.n_regressors)
        t0 = time.perf_counter()
        gp.update(x_new.astype(np.float32), y_new.astype(np.float32))
        gp.posterior()
        synchronize(dev)
        upd_lat.append(time.perf_counter() - t0)
    rep = report(f"online: served {batches} batches x {batch}", serve_lat, batch, log)
    upd = np.asarray(upd_lat[1:]) * 1e3
    upd_p50, upd_p99 = float(np.percentile(upd, 50)), float(np.percentile(upd, 99))
    log(f"online: absorbed {arrive} obs/batch in p50={upd_p50:.2f}ms "
        f"p99={upd_p99:.2f}ms vs full refactorize {t_refit * 1e3:.2f}ms "
        f"({t_refit * 1e3 / upd_p50:.1f}x)")
    assert gp.y_train.shape[0] <= n, "sliding window must cap the set"
    return dict(offline_s=offline_s, latencies_s=serve_lat, **rep, update_p50_ms=upd_p50, update_p99_ms=upd_p99,
                refit_ms=t_refit * 1e3, window=int(gp.y_train.shape[0]), gp=gp, probe=xt, served=last)


def run(device="cuda", *, n=4096, tile=512, batch=256, batches=32, fleet=0, ragged=0, online=False, arrive=32,
        metrics=None, log=print) -> dict:
    """One serving run in the mode the arguments choose, as the command line runs it; returns its numbers."""
    dev = resolve_device(device)
    build_s = build_kernels(dev)
    if dev.type == "cuda":
        log(f"kernels built and loaded: {build_s:.2f}s")
    if metrics:
        obs.enable(metrics)
    cfg = MSDConfig()
    sizes = dict(n=n, tile=tile, batch=batch, batches=batches, log=log)
    try:
        if ragged > 0:
            out = serve_ragged(cfg, dev, b=ragged, arrive=arrive, **sizes)
        elif online:
            out = serve_online(cfg, dev, arrive=arrive, **sizes)
        elif fleet > 0:
            out = serve_fleet(cfg, dev, b=fleet, **sizes)
        else:
            out = serve_single(cfg, dev, **sizes)
        if metrics:
            # health + cache tallies ride along as final events so the JSONL
            # is self-contained (no second file for the snapshot)
            snap = obs.snapshot()
            obs.event("serve.health", counters={k: v for k, v in snap["counters"].items() if k.startswith("health.")})
            obs.event("obs.cache_stats", caches=obs.cache_stats())
            out["events"] = len(obs.registry().events)
            log(f"metrics: wrote {out['events']}+ events to {metrics}")
    finally:
        if metrics:
            obs.disable()
    out["build_s"] = build_s
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256, help="requests per batch")
    ap.add_argument("--batches", type=int, default=32)
    ap.add_argument("--fleet", type=int, default=0, metavar="B",
                    help="serve B independent GPs through one GPBatch program")
    ap.add_argument("--ragged", type=int, default=0, metavar="B",
                    help="serve B differently-sized GPs through GPFleet + continuous batching")
    ap.add_argument("--online", action="store_true",
                    help="interleave observation arrivals with requests (streaming updates)")
    ap.add_argument("--arrive", type=int, default=32, help="observations arriving per batch (--online/--ragged)")
    ap.add_argument("--metrics", metavar="OUT.jsonl", default=None,
                    help="enable repro_torch.obs telemetry and stream events to a JSONL file")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    run(args.device, n=args.n, tile=args.tile, batch=args.batch, batches=args.batches, fleet=args.fleet,
        ragged=args.ragged, online=args.online, arrive=args.arrive, metrics=args.metrics)


if __name__ == "__main__":
    main()
