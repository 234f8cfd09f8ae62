#!/usr/bin/env python3
"""The sharded LM step's two optimizer routes for Adam, timed in turns in one 4-rank world on one card.

``make_train_step(cfg, opt, mesh, shape)`` updates an ``Adam``'s blocks in
place, clipped by the global norm of the full gradients; any other
optimizer (Adafactor, whose factored moments read whole leaves) has its
state gathered, updates the full leaves and keeps the rank's blocks.  This
script gives the same ``Adam`` to both routes (``Gathered`` hides its type)
at chip_smoke's lm.mesh cell (olmo-1b at full width, depth 2, float32,
B x S = 4 x 512, a 2 x 2 ("data", "model") mesh of ranks sharing the one
card over gloo) and times ``PAIRS`` pairs of steps in turns (blocks first,
then gathered first), each between barriers after an untimed warm step of
each.  From the root of a checkout, on a card:

    python3 scripts/ab_lm_mesh_adam.py

prints the card's name and power limit, then one JSON line: each rank's
seconds, collectives (calls, bytes, host seconds) and peak memory a step by
route, each route's median over the ranks' steps, and the largest
difference between the two routes' parameters (0: the same arithmetic).
"""

import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402  (its lm.mesh cell, its ranks and their clock)

PAIRS = 4


class Gathered:
    """An optimizer that is not an ``Adam``: the sharded step gathers its state."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        return self.opt.update(grads, state, params)


def ab_job(rank, world):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adam
    from repro_torch.train import make_train_step

    cs = chip_smoke
    dev = cs._here()
    cfg = dataclasses.replace(configs.get_config(cs.LM_MESH_ARCH), n_layers=cs.LM_CUT_LAYERS, param_dtype="float32",
                              activation_dtype="float32")
    mesh = make_test_mesh((2, 2), ("data", "model"))
    model = tf.init_model(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev)
    tok, lab = cs.lm_batch(cfg, cs.LM_MESH_B, cs.LM_MESH_S, cs.SEED, dev)[0]
    opt = Adam(learning_rate=cs.LM_MESH_LR)
    shape = ShapeConfig("lm_mesh", cs.LM_MESH_S, cs.LM_MESH_B, "train")
    steps = {"blocks": make_train_step(cfg, opt, mesh, shape, donate=False)[0],
             "gathered": make_train_step(cfg, Gathered(opt), mesh, shape, donate=False)[0]}
    shardings = make_train_step(cfg, opt, mesh, shape)[1]
    blocks = sh.distribute(dict(model.named_parameters()), shardings["params"])
    state = sh.distribute(opt.init(model), shardings["opt"])
    del model
    torch.cuda.empty_cache()
    params = {name: fn(blocks, state, tok, lab)[0] for name, fn in steps.items()}  # warm: kernels load here
    diff = max(float((params["blocks"][n] - params["gathered"][n]).abs().max()) for n in params["blocks"])
    del params
    out = {name: [] for name in steps}
    for i in range(PAIRS):
        for name in ("blocks", "gathered") if i % 2 == 0 else ("gathered", "blocks"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            coll.reset_stats()
            _, seconds = cs.timed_between_barriers(lambda: steps[name](blocks, state, tok, lab))
            out[name].append(dict(seconds=seconds, collectives=dict(coll.STATS),
                                  peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30))
    return dict(steps=out, params_diff=diff)


chip_smoke.RANK_JOBS["ab_lm_mesh_adam"] = ab_job  # at module level: the spawned ranks import this file again


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ab_lm_mesh_adam.py needs a CUDA card")
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()  # here, so that the ranks only load the kernels
    ranks, world_seconds = chip_smoke.Ranks("ab_lm_mesh_adam", 4).join()
    medians = {name: statistics.median(s["seconds"] for r in ranks for s in r["steps"][name])
               for name in ("blocks", "gathered")}
    print(json.dumps({"cell": "lm.mesh (chip_smoke.py)", "pairs": PAIRS, "median_seconds": medians,
                      "gathered_over_blocks": medians["gathered"] / medians["blocks"],
                      "params_diff": max(r["params_diff"] for r in ranks), "world_seconds": world_seconds,
                      "by_rank": [r["steps"] for r in ranks]}), flush=True)


if __name__ == "__main__":
    main()
