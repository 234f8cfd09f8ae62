"""Production dry-run: every (arch × shape × mesh) cell and the GP cells, run on meta tensors by rank 0.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell on 512 placeholder devices.  Here one process
initializes torch's ``fake`` process-group backend with the production
world (256 ranks for the (16, 16) mesh, 512 for (2, 16, 16)): its
collectives return at once and move nothing.  The process is rank 0 of
that world and runs rank 0's share of the sharded step on meta tensors,
which carry shapes and hold no data, through the entry points a user
calls (``make_train_step``, ``make_prefill_step``, ``make_decode_step``,
``distributed_gp_predict_fn``).  Per cell it

  1. builds the production mesh (``device_type="cpu"``: no rank binds to a card),
  2. builds the step and rank 0's blocks of its parameters, optimizer state
     and caches, and the global inputs (``launch/specs.py``),
  3. runs the step under ``launch.analysis.measure``: FLOPs, unfused bytes,
     the collectives (op, group, bytes; the reference's wire model), the
     kernels' launches and the peak bytes the rank holds,
  4. (single mesh) runs the probes, each part of the step alone,
  5. writes one JSON record under ``--out`` for ``launch/roofline.py``.

A cell that raises is recorded with its error and traceback; no cell is
dropped.  A world is made once a process, so each mesh (each world size)
runs in a process of its own: ``--mesh both`` starts one for each.

Usage:
  python -m repro_torch.launch.dryrun                      # all LM cells, both meshes
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --gp                 # the paper's GP cells
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

OUT_DIR = "build/dryrun"  # git-ignored


def _record_path(out_dir, name):
    return os.path.join(out_dir, f"{name}.json")


def init_world(world: int) -> None:
    """This process as rank 0 of a ``fake``-backend world of ``world`` ranks (once a process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"this process holds a world of {dist.get_world_size()} ranks, not {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _mesh(multi_pod: bool):
    from repro_torch.launch.mesh import make_production_mesh

    init_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _measured(fn, *args):
    """``fn(*args)`` counted, its arguments resident from the start."""
    from repro_torch.launch import analysis

    with analysis.measure(resident=args) as m:
        fn(*args)
    return m


def pick_optimizer(cfg):
    from repro_torch.optim import Adafactor, Adam

    if cfg.param_count() > 2e10:
        return Adafactor(learning_rate=1e-3), "adafactor"
    return Adam(learning_rate=1e-4), "adam"


def _totals(parts):
    """The probes' sum, each part times its trips."""
    tot = {"flops": 0.0, "bytes": 0.0, "wire_bytes": 0.0}
    for p in parts.values():
        t = p["trips"]
        tot["flops"] += p["cost"]["flops"] * t
        tot["bytes"] += p["cost"]["bytes"] * t
        tot["wire_bytes"] += p["collectives"]["total_wire_bytes"] * t
    return tot


def _part(fn, args, trips):
    from repro_torch.launch import analysis

    m = _measured(fn, *args)
    return {**analysis.analyze(m), "trips": trips, "times": {"meta_run_s": m.seconds}}


def run_lm_probes(cfg, shape, mesh):
    from repro_torch.launch import specs as sp

    out = {}
    fn, args, _, trips = sp.cycle_probe(cfg, shape, mesh)
    out["cycle"] = _part(fn, args, trips)
    fn, args, _, trips = sp.head_probe(cfg, shape, mesh)
    out["head"] = _part(fn, args, trips)
    if shape.kind == "train":
        opt, _ = pick_optimizer(cfg)
        fn, args, _, trips = sp.optimizer_probe(cfg, opt, mesh)
        out["optimizer"] = _part(fn, args, trips)
    return out


def _finish(rec, m, probes, probe_fn):
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import H100_SXM

    rec["times"] = {"meta_run_s": m.seconds}
    rec["full"] = analysis.analyze(m)
    rec["fits_80gb"] = rec["full"]["memory"]["peak_bytes"] < H100_SXM.hbm_bytes
    cost, mem = rec["full"]["cost"], rec["full"]["memory"]
    print(f"    flops/rank={cost['flops']:.4e} bytes/rank={cost['bytes']:.4e} "
          f"wire/rank={rec['full']['collectives']['total_wire_bytes']:.4e} peak={mem['peak_bytes'] / 1e9:.2f} GB "
          f"({m.seconds:.1f} s)")
    if probes:
        rec["probes"] = probe_fn()
        rec["probes_total"] = _totals(rec["probes"])
    rec["corrected"] = "full"  # eager torch runs every layer: the full run's totals need no trip-count correction
    rec["ok"] = True


def _write(rec, path, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _failed(rec, e):
    rec["error"] = f"{type(e).__name__}: {e}"
    rec["traceback"] = traceback.format_exc()[-2000:]
    print(f"    [FAIL] {rec['error']}")


def lm_step(cfg, shape, mesh=None, optimizer=None):
    """(fn, *args) of one step of an LM cell as rank 0 runs it on meta tensors: the sharded step's entry point
    (unsharded with ``mesh=None``), this rank's blocks of the parameters, optimizer state and caches, and the global
    inputs.  A decode step's position is a host int (``decode_fn`` reads it): the last slot of a full cache."""
    from repro_torch.dist import sharding as shard_rules
    from repro_torch.launch import specs as sp
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train.train_step import make_train_step

    ins = sp.input_specs(cfg, shape)
    model = sp.params_shape(cfg)
    named = dict(model.named_parameters())

    def params(shd):
        return model if shd is None else sp.rank_blocks(named, shd["params"])

    if shape.kind == "train":
        step, shd = make_train_step(cfg, optimizer, mesh, shape)
        state = optimizer.init(model)
        state = state if shd is None else shard_rules.distribute(state, shd["opt"])
        return step, params(shd), state, ins["inputs"], ins["labels"]
    if shape.kind == "prefill":
        fn, shd = make_prefill_step(cfg, mesh, shape)
        return fn, params(shd), ins["inputs"]
    fn, shd = make_decode_step(cfg, mesh, shape)
    caches = ins["caches"] if shd is None else [sp.rank_blocks(c, s) for c, s in zip(ins["caches"], shd["caches"])]
    return fn, params(shd), ins["token"], shape.seq_len - 1, caches


def gp_predict(gp_shape, mesh, row_axes, col_axes, d_feat: int = 16):
    """(fn, *args) of a GP cell's distributed prediction with variances, on meta tensors."""
    import torch

    from repro_torch.core import distributed as dgp
    from repro_torch.core.kernels_math import SEKernelParams

    n, m = gp_shape.n_train, gp_shape.tile_size
    m_tiles, nt = n // m, gp_shape.n_test
    fn = dgp.distributed_gp_predict_fn(mesh, m_tiles=m_tiles, tile_size=m, n_valid=n, n_test_valid=nt,
                                       params=SEKernelParams.paper_defaults(), row_axes=row_axes, col_axes=col_axes)
    meta = torch.device("meta")
    return (fn, torch.empty((m_tiles, m, d_feat), device=meta), torch.empty((m_tiles, m), device=meta),
            torch.empty((nt // m, m, d_feat), device=meta))


def run_lm_cell(arch, shape, multi_pod, out_dir=OUT_DIR, probes=True, force=False):
    from repro_torch import configs

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{arch}__{shape.name}__{mesh_name}"
    path = _record_path(out_dir, name)
    if os.path.exists(path) and not force:
        print(f"  [skip] {name} (cached)")
        with open(path) as f:
            return json.load(f)
    print(f"  [cell] {name}")
    cfg = configs.get_config(arch)
    rec = {"kind": "lm", "arch": arch, "shape": dataclasses.asdict(shape), "mesh": mesh_name,
           "params": cfg.param_count(), "active_params": cfg.active_param_count(),
           "compute_dtype": cfg.activation_dtype, "ok": False}
    try:
        mesh = _mesh(multi_pod)
        rec["devices"] = mesh.size()
        opt = None
        if shape.kind == "train":
            opt, rec["optimizer"] = pick_optimizer(cfg)
        rec["model_flops"] = (6.0 if shape.kind == "train" else 2.0) * cfg.active_param_count() * (
            shape.global_batch if shape.kind == "decode" else shape.tokens)
        m = _measured(*lm_step(cfg, shape, mesh, opt))
        _finish(rec, m, probes and not multi_pod, lambda: run_lm_probes(cfg, shape, mesh))
    except Exception as e:  # noqa: BLE001 - a cell's failure is its record; the sweep goes on
        _failed(rec, e)
    return _write(rec, path, out_dir)


def run_gp_cell(gp_shape, multi_pod, out_dir=OUT_DIR, probes=True, force=False, d_feat=16):
    import torch

    from repro_torch.core import distributed as dgp

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"gp__{gp_shape.name}__{mesh_name}"
    path = _record_path(out_dir, name)
    if os.path.exists(path) and not force:
        print(f"  [skip] {name} (cached)")
        with open(path) as f:
            return json.load(f)
    print(f"  [cell] {name}")
    row_axes = ("pod", "data") if multi_pod else ("data",)
    col_axes = ("model",)
    n, m = gp_shape.n_train, gp_shape.tile_size
    m_tiles, nt = n // m, gp_shape.n_test
    rec = {"kind": "gp", "arch": "gp-tiled-cholesky", "shape": dataclasses.asdict(gp_shape), "mesh": mesh_name,
           "m_tiles": m_tiles, "compute_dtype": "float32", "ok": False,
           # cholesky n^3/3 + solves 2n^2 + V-solve n^2*nt + mean 2*n*nt
           "model_flops": n ** 3 / 3.0 + 2.0 * n * n + float(n) * n * nt + 2.0 * n * nt}
    try:
        mesh = _mesh(multi_pod)
        rec["devices"] = mesh.size()
        mm = _measured(*gp_predict(gp_shape, mesh, row_axes, col_axes, d_feat))
        meta = torch.device("meta")

        def gp_probes():
            p, q = dgp.grid_shape(mesh, row_axes, col_axes)
            local = torch.empty((m_tiles // p, m_tiles // q, m, m), device=meta)
            chol = dgp.cholesky_step_probe_fn(mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes)
            var = dgp.variance_step_probe_fn(mesh, m_tiles=m_tiles, row_axes=row_axes, col_axes=col_axes)
            b = torch.empty((m_tiles, nt // m // q, m, m), device=meta)
            return {"chol_step": _part(chol, (local, 0), m_tiles), "var_step": _part(var, (local, b, 0), m_tiles)}

        _finish(rec, mm, probes, gp_probes)
    except Exception as e:  # noqa: BLE001
        _failed(rec, e)
    return _write(rec, path, out_dir)


def _run_mesh(args, multi: bool):
    from repro_torch import configs
    from repro_torch.configs import gp_msd

    results = []
    if args.gp:
        for s in gp_msd.ALL_GP_SHAPES:
            if args.gp_shape is None or s.name in args.gp_shape:
                results.append(run_gp_cell(s, multi, args.out, not args.no_probes, args.force))
        return results
    for arch in args.arch or list(configs.ARCH_IDS):
        for shape in configs.shapes_for(arch):
            if args.shape and shape.name not in args.shape:
                continue
            results.append(run_lm_cell(arch, shape, multi, args.out, not args.no_probes, args.force))
    return results


def main(argv=None):
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None, choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--gp", action="store_true", help="run the paper's GP cells")
    ap.add_argument("--gp-shape", action="append", default=None)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--force", action="store_true")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    if args.mesh == "both":  # one world a process: each mesh in a child of its own
        t0 = time.time()
        rcs = []
        for mesh in ("single", "multi"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *_without_mesh(argv), "--mesh", mesh]
            rcs.append(subprocess.call(cmd))
        print(f"== dry-run, both meshes: {time.time() - t0:.1f} s, exit codes {rcs} ==")
        return max(rcs)
    results = _run_mesh(args, args.mesh == "multi")
    ok = sum(1 for r in results if r.get("ok"))
    print(f"\n== dry-run ({args.mesh}): {ok}/{len(results)} cells OK ==")
    for r in results:
        if not r.get("ok"):
            print(f"  FAILED: {r.get('arch')}/{r['shape'].get('name')}/{r['mesh']}: {r.get('error')}")
    return 0 if ok == len(results) else 1


def _without_mesh(argv):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--mesh":
            skip = True
        elif not a.startswith("--mesh="):
            out.append(a)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
