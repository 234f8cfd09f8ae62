"""Spawned gloo worlds for the port's multi-device tests (torch only: the workers never import JAX).

``World(fn, world, *args)`` starts ``world`` processes with
``torch.multiprocessing.start_processes``; each initializes the default
group over gloo on a ``FileStore`` of its own (no port to pick), calls
``fn(rank, world, *args)`` and saves what it returns, and ``join()``
returns the list by rank, so that the caller can work while the world
runs.  A worker that raises fails the
join, and so the caller; a world that outlives ``timeout`` seconds from its
start is killed.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, *args), os.path.join(tmp, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class World:
    """A spawned gloo world running ``fn(rank, world, *args)`` on every rank."""

    def __init__(self, fn, world: int, *args, timeout: float = 120.0):
        self.world, self.timeout = world, timeout
        self._tmp = tempfile.TemporaryDirectory()
        self._ctx = mp.start_processes(_entry, args=(world, self._tmp.name, fn, args), nprocs=world, join=False,
                                       start_method="spawn")
        self._deadline = time.monotonic() + timeout

    def join(self):
        """Every rank's result, by rank; kills the world and raises past the deadline."""
        try:
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > self._deadline:
                    self.kill()
                    raise TimeoutError(f"the {self.world}-rank world did not finish in {self.timeout} s")
            return [torch.load(os.path.join(self._tmp.name, f"out{r}.pt"), weights_only=False)
                    for r in range(self.world)]
        finally:
            self._tmp.cleanup()

    def kill(self):
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# The sharded-fleet cases, run by every rank of a 4-rank world
# ---------------------------------------------------------------------------

# pow2 buckets at tile 16: one tile {3, 4, 5, 6} (splits over data = 2), two tiles {0, 1, 2} (replicated).
# Problem 3 migrates (10 + 8 = 18 rows) from rank data 0's half of the first into the second's new data-1 half:
# afterwards {4, 5, 6} replicate and {0, 1, 2, 3} split.  The batcher's observations migrate nothing.
FLEET_SIZES = (20, 26, 25, 10, 8, 12, 14)
FLEET_ARRIVALS = (3, 0, 4, 8, 0, 1, 2)
FLEET_TESTS = (3, 0, 5, 2, 4, 1, 6)


def fleet_data(seed: int = 1, d: int = 2):
    import numpy as np

    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n, d)).astype(np.float32) for n in FLEET_SIZES]
    ys = [rng.standard_normal(n).astype(np.float32) for n in FLEET_SIZES]
    xt = rng.standard_normal((6, d)).astype(np.float32)
    tests = [rng.standard_normal((k, d)).astype(np.float32) for k in FLEET_TESTS]
    xa = [rng.standard_normal((k, d)).astype(np.float32) for k in FLEET_ARRIVALS]
    ya = [rng.standard_normal(k).astype(np.float32) for k in FLEET_ARRIVALS]
    return xs, ys, xt, tests, xa, ya


def fleet_lowrank_options():
    """The low-rank fleet's options: 8 pinned inducing points."""
    import numpy as np

    u = np.random.default_rng(4).standard_normal((8, 2)).astype(np.float32)
    return dict(method="lowrank", m_inducing=8, inducing=u)


def batch_data(b: int, n: int = 48, d: int = 3, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    y = rng.standard_normal((b, n)).astype(np.float32)
    xt = rng.standard_normal((8, d)).astype(np.float32)
    xa = rng.standard_normal((b, 16, d)).astype(np.float32)
    ya = rng.standard_normal((b, 16)).astype(np.float32)
    return x, y, xt, xa, ya


def _np(t):
    """Tensors (torch or JAX) to numpy arrays, through tuples and lists."""
    import numpy as np

    if isinstance(t, (tuple, list)):
        return type(t)(_np(v) for v in t)
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t) if hasattr(t, "__array__") else t


def batch_case(gp_cls_kwargs, b, mesh):
    """GPBatch: cold predict with uncertainty, nlml, a warm update and a warm predict."""
    from repro_torch.core import GPBatch

    x, y, xt, xa, ya = batch_data(b)
    gp = GPBatch(x, y, tile_size=16, device="cpu", mesh=mesh, **gp_cls_kwargs)
    out = {"cold": _np(gp.predict_with_uncertainty(xt)), "nlml": _np(gp.nlml())}
    gp.update(xa, ya)
    out["warm_after_update"] = gp._cache_warm() or gp._lowrank_warm()
    out["after_update"] = _np(gp.predict(xt))
    out["local_rows"] = (gp._posterior or gp._lowrank).x_chunks.shape[0] if hasattr(
        gp._posterior or gp._lowrank, "x_chunks") else gp._lowrank.u_chunks.shape[0]
    return out


def fleet_case(mesh, **kw):
    """GPFleet: predict with uncertainty, predict_each, nlml, then a migrating update and predict."""
    from repro_torch.core import GPFleet

    xs, ys, xt, tests, xa, ya = fleet_data()
    fleet = GPFleet(xs, ys, tile_size=16, device="cpu", mesh=mesh, **kw)
    out = {"cold": _np(fleet.predict_with_uncertainty(xt)), "each": _np(fleet.predict_each(tests)),
           "nlml": _np(fleet.nlml())}
    fleet.update(xa, ya)
    out["warm_after_update"] = all(rec.state is not None for rec in fleet._buckets.values())
    out["after_update"] = _np(fleet.predict(xt))
    out["local_widths"] = {cap: int(rec.state.lpacked.shape[0] if hasattr(rec.state, "lpacked")
                                    else rec.state.u_chunks.shape[0]) for cap, rec in fleet._buckets.items()}
    return out, fleet


def serve_case(fleet, batcher_cls=None):
    """Two waves of ``batcher_cls`` (the port's ContinuousBatcher) over a fleet: predictions, then observations
    and predictions."""
    import numpy as np

    if batcher_cls is None:
        from repro_torch.serve import ContinuousBatcher as batcher_cls

    rng = np.random.default_rng(5)
    batcher = batcher_cls(fleet)
    results = []
    for wave in range(2):
        handles = [batcher.submit_predict(i, rng.standard_normal((2, 2)).astype(np.float32))
                   for i in range(0, fleet.batch_size, 2)]
        for i in range(1, fleet.batch_size, 3):
            batcher.submit_observe(i, rng.standard_normal((3, 2)).astype(np.float32),
                                   rng.standard_normal(3).astype(np.float32))
        batcher.step()
        results.append([_np(batcher.result(h)) for h in handles])
    return results


def sharded_fleet_world(rank, world, with_mesh: bool):
    """Every case of tests/test_torch_sharded_fleet.py on this rank (``with_mesh`` False: the unsharded port)."""
    from repro_torch.core import GPBatch, executor
    from repro_torch.launch.mesh import make_fleet_mesh, make_test_mesh
    from repro_torch.train import make_gp_serve_step, make_gp_train_step

    data4 = make_fleet_mesh() if with_mesh else None                 # ("data",) over 4 ranks
    grid = make_test_mesh((2, 2), ("data", "model")) if with_mesh else None
    one = make_fleet_mesh(1) if with_mesh else None
    out = {}
    x, y, xt, _, _ = batch_data(4)
    GPBatch(x, y, tile_size=16, device="cpu").predict(xt)            # the unsharded plans first
    plans_before = executor.program_plan.cache_info()
    out["batch4"] = batch_case({}, 4, data4)
    out["batch6"] = batch_case({}, 6, data4)
    out["plans_same"] = executor.program_plan.cache_info().misses == plans_before.misses
    out["batch4_lowrank"] = batch_case({"method": "lowrank", "m_inducing": 16}, 4, data4)
    out["fleet"], fleet = fleet_case(grid)
    out["fleet_lowrank"], _ = fleet_case(grid, **fleet_lowrank_options())
    out["serve"] = serve_case(fleet)
    serve, sh = make_gp_serve_step(GPBatch(x, y, tile_size=16, device="cpu"), data4, uncertainty=True)
    out["serve_step"] = _np(serve(xt))
    out["serve_shardings"] = None if sh is None else (str(sh["x_test"]), sh["batch_axes"])
    train, _ = make_gp_train_step(GPBatch(x, y, tile_size=16, device="cpu"), data4, lr=0.05)
    out["train_step"] = _np(train(steps=2))
    plans = executor.program_plan.cache_info()
    out["plans"] = (plans.misses, plans.currsize)
    if with_mesh and rank == 0:                                    # a 1-rank mesh: rank 0 alone is on it
        out["batch4_one"] = batch_case({}, 4, one)
    if with_mesh:
        out["checks"] = extra_fleet_checks(rank, world)
    return out


def extra_fleet_checks(rank, world):
    """Mesh validation, the step factories' refusals, and a single GP under a mesh (returns what raised)."""
    from repro_torch.core import GaussianProcess, GPFleet
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.train import attach_mesh, make_gp_serve_step, make_gp_train_step

    out = {}
    for n in (0, world + 1):
        try:
            make_fleet_mesh(n)
            out[f"fleet_mesh_{n}"] = "no error"
        except ValueError as e:
            out[f"fleet_mesh_{n}"] = f"ValueError: {e}"
    mesh = make_fleet_mesh()
    xs, ys, _, tests, _, _ = fleet_data()
    fleet = GPFleet(xs[:2], ys[:2], tile_size=16, device="cpu")
    serve, sh = make_gp_serve_step(fleet, mesh)
    out["fleet_mesh_installed"] = fleet.mesh is mesh and sh == {"mesh": mesh}
    out["fleet_serve_each"] = [o.shape[0] for o in serve(tests[:2])]
    train, _ = make_gp_train_step(fleet, mesh)
    try:
        train()
        out["fleet_train"] = "no error"
    except NotImplementedError:
        out["fleet_train"] = "NotImplementedError"
    gp = GaussianProcess(xs[1], ys[1], tile_size=16, device="cpu")
    serve1, sh1 = make_gp_serve_step(gp, mesh)
    out["single"] = (sh1, _np(serve1(tests[0])), _np(GaussianProcess(xs[1], ys[1], tile_size=16,
                                                                   device="cpu").predict(tests[0])))
    try:
        attach_mesh(fleet, object())
        out["attach_bad"] = "no error"
    except TypeError:
        out["attach_bad"] = "TypeError"
    return out


def distributed_world(rank, world):
    """The block-cyclic Cholesky and predict cases of tests/test_torch_distributed.py on this rank."""
    import numpy as np
    import torch
    from repro_torch.core import distributed as dist_gp
    from repro_torch.core import tiling
    from repro_torch.core.kernels_math import SEKernelParams
    from repro_torch.launch.mesh import make_test_mesh

    rng = np.random.default_rng(2)
    n, m = 128, 16
    a = rng.standard_normal((n, n)).astype(np.float32)
    k = a @ a.T + n * np.eye(n, dtype=np.float32)
    tiles = tiling.tile_dense(torch.from_numpy(k), m)
    out = {"K": k}
    grids = {"2x2": (make_test_mesh((2, 2), ("data", "model")), ("data",), ("model",)),
             "4x1": (make_test_mesh((4, 1), ("data", "model")), ("data",), ("model",)),
             "pod2x2": (make_test_mesh((2, 1, 2), ("pod", "data", "model")), ("pod", "data"), ("model",))}

    def factor(name, unroll=False, update_dtype=None):
        mesh, rows, cols = grids[name]
        p, q = dist_gp.grid_shape(mesh, rows, cols)
        fn = dist_gp.distributed_cholesky_fn(mesh, m_tiles=n // m, row_axes=rows, col_axes=cols, unroll=unroll,
                                             update_dtype=update_dtype)
        local = fn(dist_gp.local_block(dist_gp.to_cyclic_layout(tiles, p, q), mesh, rows, cols))
        cyc = dist_gp.collect_blocks(local, mesh, rows, cols)
        return np.tril(tiling.untile_dense(dist_gp.from_cyclic_layout(cyc, p, q)).numpy())

    for name in ("2x2", "4x1"):
        for unroll in (False, True):
            out[f"L_{name}_{unroll}"] = factor(name, unroll)
    out["L_pod2x2"] = factor("pod2x2")
    out["L_bf16"] = factor("2x2", update_dtype=torch.bfloat16)

    ntr, nte = 128, 32
    x = rng.standard_normal((ntr, 3)).astype(np.float32)
    y = rng.standard_normal(ntr).astype(np.float32)
    xt = rng.standard_normal((nte, 3)).astype(np.float32)
    out["data"] = (x, y, xt)
    params = SEKernelParams.paper_defaults()
    args = (tiling.pad_features(torch.from_numpy(x), m), tiling.pad_vector(torch.from_numpy(y), m),
            tiling.pad_features(torch.from_numpy(xt), m))
    mesh = grids["2x2"][0]
    pfn = dist_gp.distributed_gp_predict_fn(mesh, m_tiles=ntr // m, tile_size=m, n_valid=ntr, n_test_valid=nte,
                                            params=params)
    out["predict"] = tuple(t.numpy() for t in pfn(*args))
    out["mean_only"] = dist_gp.distributed_gp_predict_fn(
        mesh, m_tiles=ntr // m, tile_size=m, n_valid=ntr, n_test_valid=nte, params=params, variances=False,
        unroll=True)(*args).numpy()
    refused = []
    for make in (lambda: dist_gp.distributed_cholesky_fn(mesh, m_tiles=7),
                 lambda: dist_gp.distributed_gp_predict_fn(grids["4x1"][0], m_tiles=6, tile_size=m, n_valid=96,
                                                           n_test_valid=nte, params=params),
                 lambda: pfn(args[0], args[1], torch.cat([args[2], args[2][:1]]))):  # 3 test tiles, Q = 2
        try:
            make()
            refused.append("no error")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


# ---------------------------------------------------------------------------
# The language model's sharded steps, run by every rank of a 4-rank world
# ---------------------------------------------------------------------------

LM_ARCH, LM_B, LM_S, LM_DECODE_STEPS, LM_LR = "olmo-1b", 4, 16, 4, 1e-3
LM_RECURRENT_ARCH = "recurrentgemma-2b"  # served on the mesh beside LM_ARCH
# qwen3-moe's smoke model served on the mesh at capacity factor 0.5 (drops): its routing group of 64 tokens (and a
# decode step's of LM_B) holds both data ranks' rows; llava's smoke model takes a sharded step on (B, S, d) inputs
LM_MOE_ARCH, LM_MOE_CF, LM_EMBED_ARCH = "qwen3-moe-235b-a22b", 0.5, "llava-next-34b"


def lm_tokens(vocab: int, seed: int = 0):
    """(inputs, labels, decode tokens): the (B, S) batch and the B x 4 tokens fed to the decode steps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (LM_B, LM_S)).astype(np.int64), rng.integers(0, vocab, (LM_B, LM_S)).astype(np.int64),
            rng.integers(0, vocab, (LM_B, LM_DECODE_STEPS)).astype(np.int64))


def _digest(named):
    """Each tensor's sum and sum of squares, in float64: equal digests on every rank show replicated values."""
    import torch

    return torch.stack([torch.stack([t.double().sum(), t.double().square().sum()]) for t in named.values()])


def lm_mesh_world(rank, world, ckpt_dir, tree):
    """Every case of tests/test_torch_lm_mesh.py on this rank: the sharded train step (Adam, Adafactor) and the
    unsharded one, the specs and the bytes a rank holds, the compressed DP step, sharded prefill and decode, and a
    checkpoint saved from the sharded state and restored both ways; then LM_RECURRENT_ARCH's and LM_MOE_ARCH's smoke
    models (the port's own init) served under the mesh, and a sharded Adam step of LM_EMBED_ARCH's on (B, S, d)
    embeddings.  ``tree`` is the reference's parameter tree (numpy); rank 0 also returns its full
    results, which the caller holds against the JAX package's."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs, convert
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adafactor, Adam
    from repro_torch.train import make_compressed_dp_step, make_train_step
    from repro_torch.train.train_step import clone_tree

    cfg = configs.get_smoke_config(LM_ARCH)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    pod = make_test_mesh((2, 2), ("pod", "data"))
    shape = ShapeConfig("smoke", LM_S, LM_B, "train")
    tok, lab, dec = (torch.from_numpy(a) for a in lm_tokens(cfg.vocab_size))
    out = {}
    for name, opt in (("adam", Adam(learning_rate=LM_LR)), ("adafactor", Adafactor(learning_rate=LM_LR,
                                                                                   min_dim_size_to_factor=16))):
        model = convert.lm_params_from_numpy(tree, cfg, "cpu")
        plain, _ = make_train_step(cfg, opt, donate=False)
        p1, o1, l1 = plain(model, opt.init(model), tok, lab)
        step, shardings = make_train_step(cfg, opt, mesh, shape)
        blocks = sh.distribute(dict(model.named_parameters()), shardings["params"])
        state = sh.distribute(opt.init(model), shardings["opt"])
        out[f"{name}.bytes"] = (sh.local_bytes(blocks), sh.local_bytes(state))
        p2, o2, l2 = step(blocks, state, tok, lab)
        full_p, full_o = sh.collect(p2, shardings["params"]), sh.collect(o2, shardings["opt"])
        out[f"{name}.loss"] = (float(l1), float(l2))
        out[f"{name}.params"] = max(float((full_p[n] - p).abs().max()) for n, p in p1.named_parameters())
        out[f"{name}.state"] = max(float((a - b).abs().max()) for a, b in zip(_leaves(full_o), _leaves(o1)))
        if rank == 0:
            out[f"{name}.full"] = dict(params=full_p, state=full_o, loss=float(l2))
        if name == "adam":
            out["specs"] = {n: (tuple(dict(model.named_parameters())[n].shape), s.spec)
                            for n, s in shardings["params"].items()}
            out["opt_specs"] = {k: {n: s.spec for n, s in v.items()} for k, v in shardings["opt"].items()
                                if isinstance(v, dict)}
            out["input_spec"] = shardings["inputs"].spec
            out["block_shapes"] = {n: tuple(b.shape) for n, b in p2.items()}
            # a checkpoint from the sharded state: gathered by every rank, written by rank 0, restored unsharded
            # (bitwise the gathered state) and sharded again (bitwise this rank's blocks)
            if rank == 0:
                CheckpointManager(ckpt_dir).save(1, {"params": full_p, "opt": full_o})
            dist.barrier()
            mgr = CheckpointManager(ckpt_dir)
            template = tf.init_model(cfg, 1, device="cpu")
            _, unsharded = mgr.restore({"params": template, "opt": opt.init(template)})
            out["ckpt.unsharded_bitwise"] = (
                all(torch.equal(p, full_p[n]) for n, p in template.named_parameters())
                and all(torch.equal(a, b) for a, b in zip(_leaves(unsharded["opt"]), _leaves(full_o))))
            _, resharded = mgr.restore({"params": clone_tree(p2), "opt": clone_tree(o2)},
                                       shardings={"params": shardings["params"], "opt": shardings["opt"]})
            out["ckpt.sharded_bitwise"] = (all(torch.equal(resharded["params"][n], b) for n, b in p2.items())
                                           and all(torch.equal(a, b) for a, b in zip(_leaves(resharded["opt"]),
                                                                                     _leaves(o2))))
    # the compressed data-parallel step on ("pod", "data") against the plain step
    model = convert.lm_params_from_numpy(tree, cfg, "cpu")
    opt = Adam(learning_rate=LM_LR)
    plain, _ = make_train_step(cfg, opt, donate=False)
    p1, o1, l1 = plain(model, opt.init(model), tok, lab)
    comp, init_err = make_compressed_dp_step(cfg, opt, pod, compress_axis="pod")
    p2, o2, err, l2 = comp(model, opt.init(model), init_err(model), tok, lab)
    named = dict(p2.named_parameters())
    out["compressed"] = (float(l1), float(l2), max(float((a - b).abs().max()) for a, b in
                                                   zip(p1.parameters(), p2.parameters())),
                         max(float(e.abs().max()) for e in err.values()))
    # Adam's first moments, linear in the averaged gradient: the int8 mean's error, against each parameter's largest
    out["compressed.m_err"] = max(float((o2["m"][n] - m).abs().max() / m.abs().max()) for n, m in o1["m"].items())
    out["compressed.digest"] = _digest(named)
    if rank == 0:
        out["compressed.full"] = dict(params={n: p.detach() for n, p in named.items()}, m=o2["m"], err=err,
                                      loss=float(l2))
    # prefill and decode (the given tokens) under the mesh against unsharded
    diffs, served, caches_sh, shd, out["donate_cache_false_keeps"] = _serve_on_mesh(cfg, model, mesh, tok, dec)
    out["serve.diffs"] = diffs
    out["serve.cache_rows"] = caches_sh[0]["k"].shape[0]
    out["serve.cache_specs"] = [c["k"].spec for c in shd["caches"]]
    if rank == 0:
        out["serve.logits"] = served
    # the recurrent states ({"h", "conv"} on rglru layers) beside a local ring: recurrentgemma's smoke model
    rcfg = configs.get_smoke_config(LM_RECURRENT_ARCH)
    diffs, _, caches_sh, shd, _ = _serve_on_mesh(rcfg, tf.init_model(rcfg, 0, device="cpu"), mesh, tok, dec)
    out["recurrent.diffs"] = diffs
    out["recurrent.cache_rows"] = [{k: t.shape[0] for k, t in c.items()} for c in caches_sh]
    out["recurrent.cache_specs"] = [{k: s.spec for k, s in c.items()} for c in shd["caches"]]
    # the MoE: routing groups that straddle the data ranks, with drops
    import dataclasses

    import numpy as np

    from repro_torch.models import moe

    mcfg = dataclasses.replace(configs.get_smoke_config(LM_MOE_ARCH), capacity_factor=LM_MOE_CF)
    mtok, _, mdec = (torch.from_numpy(a) for a in lm_tokens(mcfg.vocab_size, seed=1))
    mmodel = tf.init_model(mcfg, 0, device="cpu")
    with moe.recording() as rec:
        tf.prefill_fn(mmodel, mcfg, mtok)
    out["moe.dropped"] = [int((~r["kept"]).sum()) for r in rec]
    calls = coll.STATS["calls"]
    out["moe.diffs"], _, _, _, _ = _serve_on_mesh(mcfg, mmodel, mesh, mtok, mdec)
    out["moe.collective_calls"] = coll.STATS["calls"] - calls
    out["moe.group_and_rows"] = (min(mcfg.router_group_size, LM_B * LM_S), LM_B // 2 * LM_S)
    # the embeddings input: a sharded Adam step on (B, S, d) inputs against the unsharded one
    ecfg = configs.get_smoke_config(LM_EMBED_ARCH)
    emb = torch.from_numpy(np.random.default_rng(2).standard_normal((LM_B, LM_S, ecfg.d_model)).astype(np.float32))
    opt = Adam(learning_rate=LM_LR)
    emodel = tf.init_model(ecfg, 0, device="cpu")
    p1, o1, l1 = make_train_step(ecfg, opt, donate=False)[0](emodel, opt.init(emodel), emb, lab)
    step, shardings = make_train_step(ecfg, opt, mesh, shape)
    p2, o2, l2 = step(sh.distribute(dict(emodel.named_parameters()), shardings["params"]),
                      sh.distribute(opt.init(emodel), shardings["opt"]), emb, lab)
    full_p, full_o = sh.collect(p2, shardings["params"]), sh.collect(o2, shardings["opt"])
    out["embed.loss"] = (float(l1), float(l2))
    out["embed.params"] = max(float((full_p[n] - p).abs().max()) for n, p in p1.named_parameters())
    out["embed.state"] = max(float((a - b).abs().max()) for a, b in zip(_leaves(full_o), _leaves(o1)))
    out["embed.input_spec"] = shardings["inputs"].spec
    return out


def _serve_on_mesh(cfg, model, mesh, tok, dec):
    """Prefill and LM_DECODE_STEPS decode steps (the tokens ``dec``) under ``mesh`` and unsharded: (the largest
    logit difference of each call, the sharded logits, the sharded caches, the decode step's shardings, whether
    the unsharded ``donate_cache=False`` step left its first caches as they were)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding as sh
    from repro_torch.train import make_decode_step, make_prefill_step

    serve_shape = ShapeConfig("smoke", LM_S + LM_DECODE_STEPS, LM_B, "decode")
    prefill, _ = make_prefill_step(cfg)
    decode, _ = make_decode_step(cfg, donate_cache=False)
    prefill_sh, shp = make_prefill_step(cfg, mesh, serve_shape)
    decode_sh, shd = make_decode_step(cfg, mesh, serve_shape)
    blocks = sh.distribute(dict(model.named_parameters()), shp["params"])
    logits, caches = prefill(model, tok, LM_S + LM_DECODE_STEPS)
    logits_sh, caches_sh = prefill_sh(blocks, tok, LM_S + LM_DECODE_STEPS)
    diffs, served = [float((logits - logits_sh).abs().max())], [logits_sh]
    kept = [{k: t.clone() for k, t in c.items()} for c in caches]
    keeps = False
    for i in range(LM_DECODE_STEPS):
        token = dec[:, i:i + 1]
        new_logits, new_caches = decode(model, token, LM_S + i, caches)
        if i == 0:
            keeps = all(torch.equal(c[k], k0[k]) for c, k0 in zip(caches, kept) for k in c)
        logits, caches = new_logits, new_caches
        logits_sh, caches_sh = decode_sh(blocks, token, LM_S + i, caches_sh)
        diffs.append(float((logits - logits_sh).abs().max()))
        served.append(logits_sh)
    return diffs, served, caches_sh, shd, keeps


def _leaves(tree):
    from repro_torch.tree import leaves

    return [t for t in leaves(tree) if hasattr(t, "shape")]


# ---------------------------------------------------------------------------
# The launch tools: rank 0's counts of real steps (a gloo world) and of the dry-run's meta steps (a fake world)
# ---------------------------------------------------------------------------

LAUNCH_ARCH, LAUNCH_B, LAUNCH_S = "olmo-1b", 4, 16
LAUNCH_GP = dict(n_train=128, n_test=32, tile_size=16, d=3)


def launch_shapes():
    from repro_torch.configs.base import GPShapeConfig, ShapeConfig

    return (ShapeConfig("smoke_train", LAUNCH_S, LAUNCH_B, "train"),
            GPShapeConfig("gp_launch", LAUNCH_GP["n_train"], LAUNCH_GP["n_test"], LAUNCH_GP["tile_size"]))


def _launch_counts(m):
    """The counts that the meta run and the real run must share, from a ``launch.analysis.Measurement``."""
    coll = m.collectives
    return {"flops": m.flops["aten"], "kernel_flops": m.flops["kernels"],
            "kernel_calls": {k: v["calls"] for k, v in m.kernels.items()}, "launches": dict(m.launches),
            "launched": dict(m.launched),
            "collectives": (coll.ops, coll.operand_bytes, coll.wire_bytes)}


def launch_gp_data():
    import numpy as np

    rng = np.random.default_rng(3)
    n, nt, d = LAUNCH_GP["n_train"], LAUNCH_GP["n_test"], LAUNCH_GP["d"]
    return (rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((nt, d)).astype(np.float32))


def launch_world(rank, world):
    """Rank 0's counts of olmo-1b's smoke Adam step and of the small GP cell on a (2, 2) mesh, run on CPU tensors;
    and the GP probes chained over every step, against the factorization and the variances they break down."""
    import torch

    from repro_torch import configs
    from repro_torch.core import distributed as dgp
    from repro_torch.core import tiling
    from repro_torch.core.kernels_math import SEKernelParams
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adam
    from repro_torch.train import make_train_step

    mesh = make_test_mesh((2, 2), ("data", "model"))
    shape, gp_shape = launch_shapes()
    cfg = configs.get_smoke_config(LAUNCH_ARCH)
    opt = Adam(learning_rate=1e-3)
    step, shd = make_train_step(cfg, opt, mesh, shape)
    model = tf.init_model(cfg, 0, device="cpu")
    tok, lab, _ = (torch.from_numpy(a) for a in lm_tokens(cfg.vocab_size))
    blocks = sh.distribute(dict(model.named_parameters()), shd["params"])
    state = sh.distribute(opt.init(model), shd["opt"])
    with analysis.measure(resident=(blocks, state)) as m:
        step(blocks, state, tok, lab)
    out = {"lm": _launch_counts(m)}

    x, y, xt = launch_gp_data()
    mt, n, nt = gp_shape.tile_size, gp_shape.n_train, gp_shape.n_test
    m_tiles = n // mt
    params = SEKernelParams.paper_defaults()
    xc, yc, xtc = (tiling.pad_features(torch.from_numpy(x), mt), tiling.pad_vector(torch.from_numpy(y), mt),
                   tiling.pad_features(torch.from_numpy(xt), mt))
    fn = dgp.distributed_gp_predict_fn(mesh, m_tiles=m_tiles, tile_size=mt, n_valid=n, n_test_valid=nt,
                                       params=params)
    with analysis.measure() as g:
        mean, var = fn(xc, yc, xtc)
    out["gp"] = _launch_counts(g)

    # the probes: every step chained, against distributed_cholesky_fn and the variances of the prediction
    local = dgp.local_covariance(mesh, xc, params, n)
    chol = dgp.cholesky_step_probe_fn(mesh, m_tiles=m_tiles)
    chained = local
    for j in range(m_tiles):
        chained = chol(chained, j)
    factor = dgp.distributed_cholesky_fn(mesh, m_tiles=m_tiles)(local)
    out["chol_probe_bitwise"] = torch.equal(chained, factor)
    p, q = dgp.grid_shape(mesh)
    out["factor"] = dgp.collect_blocks(factor, mesh).numpy()  # every rank gathers
    pc, mtq = coll.linear_index(mesh, ("model",)), xtc.shape[0] // q
    ti = torch.arange(m_tiles).repeat_interleave(mtq)
    tc = torch.arange(pc * mtq, (pc + 1) * mtq).repeat(m_tiles)
    b = ops.cov_tiles(xc.index_select(0, ti), xtc.index_select(0, tc), ti * mt, tc * mt, n, nt, params,
                      symmetric=False).view(m_tiles, mtq, mt, mt)
    var_step = dgp.variance_step_probe_fn(mesh, m_tiles=m_tiles)
    for j in range(m_tiles):
        b = var_step(factor, b, j)
    w_diag = torch.einsum("iqab,iqab->qb", b, b)
    out["var_probe_err"] = float((params.vertical - w_diag - var[pc * mtq:(pc + 1) * mtq]).abs().max())
    out["grid"] = (p, q)
    out["var"] = var.numpy()
    return out


def launch_meta():
    """The dry-run's side, as rank 0 of a fake world of 8 ranks: the same two cells on meta tensors on a (2, 2)
    mesh of its first four ranks, the LM probes beside the full step, and the bytes a rank holds of each smoke
    model on a (4, 2) mesh."""
    import torch

    from repro_torch import configs
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import Adam

    dryrun.init_world(8)
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    shape, gp_shape = launch_shapes()
    cfg = configs.get_smoke_config(LAUNCH_ARCH)
    out = {}
    fn, *args = dryrun.lm_step(cfg, shape, mesh, Adam(learning_rate=1e-3))
    with analysis.measure() as m:
        fn(*args)
    out["lm"] = _launch_counts(m)
    fn, *args = dryrun.gp_predict(gp_shape, mesh, ("data",), ("model",), d_feat=LAUNCH_GP["d"])
    with analysis.measure() as g:
        fn(*args)
    out["gp"] = _launch_counts(g)
    # the probes' sum against the full step, each shape kind
    probes = {}
    for kind in ("train", "prefill", "decode"):
        cell = shape.__class__(f"smoke_{kind}", LAUNCH_S, LAUNCH_B, kind)
        opt = Adam(learning_rate=1e-3) if kind == "train" else None
        fn, *args = dryrun.lm_step(cfg, cell, mesh, opt)
        with analysis.measure() as full:
            fn(*args)
        parts = {}
        for name, make in (("cycle", sp.cycle_probe), ("head", sp.head_probe)):
            pfn, pargs, _, trips = make(cfg, cell, mesh)
            with analysis.measure() as pm:
                pfn(*pargs)
            parts[name] = (analysis.cost_summary(pm)["flops"], pm.collectives.total_wire_bytes, trips)
        if kind == "train":
            pfn, pargs, _, trips = sp.optimizer_probe(cfg, opt, mesh)
            with analysis.measure() as pm:
                pfn(*pargs)
            parts["optimizer"] = (analysis.cost_summary(pm)["flops"], pm.collectives.total_wire_bytes, trips)
        probes[kind] = {"full": (analysis.cost_summary(full)["flops"], full.collectives.total_wire_bytes),
                        "parts": parts}
    out["probes"] = probes
    grid = make_test_mesh((4, 2), ("data", "model"), device_type="cpu")
    out["bytes"] = {}
    for arch in configs.ARCH_IDS:
        model = sp.params_shape(configs.get_smoke_config(arch))
        blocks = sp.rank_blocks(dict(model.named_parameters()), sh.param_shardings(model, grid))
        out["bytes"][arch] = sum(t.numel() * t.element_size() for t in blocks.values())
    out["world"] = torch.distributed.get_world_size()
    return out


def run_in_subprocess(fn_name: str, timeout: float = 300.0):
    """Start ``fn_name()`` of this module in a fresh interpreter (a world of its own): a handle whose ``result()``
    waits for it and returns what it returned."""
    import subprocess
    import sys

    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "out.pt")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(here, "..", "src"), here, env.get("PYTHONPATH", "")])
    code = (f"import torch, _torch_dist; torch.set_num_threads(1); "
            f"torch.save(_torch_dist.{fn_name}(), {path!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    class Handle:
        def result(self):
            try:
                _, err = proc.communicate(timeout=timeout)
                if proc.returncode != 0:
                    raise AssertionError(f"{fn_name} failed (rc={proc.returncode}):\n{err[-4000:]}")
                return torch.load(path, weights_only=False)
            finally:
                if proc.poll() is None:
                    proc.kill()
                tmp.cleanup()

    return Handle()
