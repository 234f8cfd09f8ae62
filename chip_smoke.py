#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. env      the card's name and power limit, torch, CUDA and nvcc versions;
2. build    compiles the eight kernel sources from src/repro_torch/kernels/csrc/
            with nvcc for sm_90a, in parallel (into build/repro_torch/,
            git-ignored);
2b. multi  (right after the build, while this process holds nothing on the
            card) a world of 2 ranks for fleet.sharded (below), spawned
            first so that it runs while this process makes data.msd:
            gp_dist_32k's data (n_train 32768, n_test 16384) from
            repro_torch.data.msd, its seconds and z-scores; then one
            spawned world of 4 ranks, all on cuda:0 over gloo (a 2 x 2
            ("data", "model") mesh; the float64 reference factors go to the
            ranks by CUDA IPC): dist.probe (both collectives on CUDA tensors),
            dist.cholesky (the MSD covariance at tile 128, M = 256, against
            a float64 factor; the bf16 update on the reference's test
            matrix A A^T + nI held to relative error < 0.02), dist.predict
            (distributed_gp_predict_fn with variances against a float64
            dense solve and beside the single-card port, rank 0's wall time
            between barriers, each rank's seconds inside collectives, its
            launches against the schedule and its peak memory) and
            dist.kernels (each kernel's widest launch, kept in a second run
            that is neither timed nor counted, held to its plain version).
            fleet.sharded: fleet_batch and fleet_ragged (a migrating
            update, two ContinuousBatcher waves) unsharded on rank 0, on a
            2-rank data mesh and on a 1-rank mesh, against each other (bitwise on the 1-rank mesh, within
            5e-4 where sharding narrows a launch, 1e-5 reported), the plan
            cache after each, and each tile op's width invariance; and
            multi.total against its 60 s budget.  P x Q ranks share one card:
            these phases prove the algorithm, not multi-GPU scaling.
            (lm.mesh, below, is the language model's world);

            ``--only-multi`` runs env, build and these phases alone;
3. kernel   one phase per kernel (kernel.tile_gemv and kernel.tile_trsv: the
            fleets' batch-invariant matvec and diagonal-tile solve at
            fleet.batch's launches, bitwise at half their width, beside one
            batched cuBLAS call, timed by device time under the profiler;
            also the GEMV_B route (tiles read transposed) and the transposed
            solve, and kernel.tile_vector.extra: ptxas registers and spills
            (0 in float32), CTAs per SM, the solve's plans and its
            dependent-chain floor): its wrapper against its plain PyTorch
            version on its path's own tiles (gp_16k, m = 512, D = 16,
            float32), plus float64 and ragged-edge cases; times the kernel,
            the plain version and one PyTorch call of the same function;
            cov_tiles also at the CROSS launch (1024 tiles); POTRF also at
            float64, at G = 31 and at m = 1024, each beside
            ``torch.linalg.cholesky``, with its ptxas registers and spills,
            bitwise-equal repeats and NaN at a non-positive pivot; TRSM also
            at G = 1, at float64, at gp_32k's m = 1024 (G = 1 and 31) and
            over the cold call's 31 launches (G = 31 ... 1, summed), each
            beside ``torch.linalg.solve_triangular``, with the strip each
            launch runs; TRAIL also at the append's launch sizes, against
            its plain version and beside ``torch.baddbmm``, and
            TRAIL's and carry's TFLOP/s; for cov_tiles, TRSM (prep and
            solve), TRAIL and carry the ptxas registers and spills (must
            be 0) and tensor-core instructions in the float32 SASS (must be
            0), CTAs per SM for TRAIL and carry; carry also at m = 2048,
            past its tallest strip, in float32 and float64;
            kernel.cov_tiles.zoo: cov_tiles for each of the seven registered
            families, SE-ARD on all 16 features and the three composites of
            the reference's zoo, at the ASSEMBLE and CROSS launches, each
            against its plain version at the kernel's stated tolerance, timed
            beside its bound; SE-ARD also on offset data; ptxas spills and
            stack frame of every instantiation (must be 0), CTAs per SM;
   grad     gradients through the kernels on the card against the CPU's (a
            low-rank NLML in float32 and float64, and a tiled log-det);
            carry_update must raise under grad, and flash_attention take
            the plain version's gradient; a GaussianProcess must
            leave the caller's TF32 flags as they were;
4. main     the gp_16k configuration (n_train = n_test = 16384, tile 512):
            a cold ``GaussianProcess.predict``, a cold
            ``predict_with_uncertainty`` and a warm ``predict``, with every
            kernel launch counted against the executor's plan, and mean and
            variance held against a float64 dense solve on the card;
5. update   the sliding-window path at gp_16k width: a window of 16384
            rows, two steps of ``update(512)`` (append one tile-row, evict
            the oldest tile) each followed by warm predictions, with the
            launches counted against the update plans and the predictions
            held against a float64 dense solve of the kept window; and a
            non-PD ``downdate_factor`` that must raise on the card;
6. timing   repeated cold and warm tiled predictions beside the dense
            ``torch.linalg.cholesky`` (cuSOLVER) pipeline, and one
            sliding-window step (append, evict) beside a cold
            refactorization of the same window;
7. profile  device time by kernel and the device's idle share in one cold
            ``predict`` and in one sliding-window step (``torch.profiler``);
7b. train  ``GaussianProcess(kernel="matern52").optimize(steps=3)`` at
            gp_16k through the blocked reverse mode, every step's launches,
            the loss curve and parameters against three Adam steps on the
            float64 dense NLML, seconds per step and peak memory;
            train.grad: the first step's gradient, each component against
            the float64 dense NLML's autograd gradient; train.autodiff: the
            composite's autograd gradient at n = 4096, each component;
    main.zoo  gp_16k's cold ``predict_with_uncertainty`` with the trained
            ``matern52`` and with Sum(Scaled(Matern52), White), launches
            against the plan, mean and variance against a float64 dense
            solve; timing.train and profile.train: one step's forward
            program, K^-1 and dense contraction;
8. kernel.lrgemm  the low-rank tier's kernel at the gp_256k build's shape
            (G = 2048 tiles of 512 x 512, float32) against its plain version,
            plus float64, odd G and mb != m; times it beside ``torch.bmm``
            (TB/s of both);
9. lowrank  gp_256k_lowrank (n_train = 262144, n_test = 16384, tile 512,
            m_inducing = 2048): a cold ``predict``, a cold
            ``predict_with_uncertainty`` and a warm ``predict`` of
            ``GaussianProcess(method="lowrank")``, then two sliding-window
            steps (``update(512)`` + an exact eviction of 512 rows) on a
            pinned inducing set, with the launches counted against the plans
            and mean and variance held against a float64 dense DTC;
10. timing.lowrank  the cold low-rank call against the float32 dense DTC,
            warm calls, a step against a cold rebuild of the window, and the
            low-rank tier against the exact tier at gp_16k;
11. profile.lowrank  device time by kernel and idle share of a cold build
            and of one step;
11b. train.lowrank  ``mll.nlml_lowrank`` at gp_256k_lowrank's sizes: value and
            blocked gradient, each component, against a float64 dense DTC
            NLML under autograd (the autodiff route measured beside it),
            then two Adam steps, with lrgemm and cov_tiles counted;
11c. fleets  kernel.cov_tiles.per_problem: cov_tiles with per-problem
            hyperparameters (a 16-row table) at fleet.batch's ASSEMBLE launch
            (16 problems x 36 tiles), SE, Matérn 5/2 and Sum(Scaled(Matern52),
            White) against the plain version, beside the same stack with
            shared params and its bound; fleet.batch: ``GPBatch`` of 16
            problems of n = 4096, n̂ = 1024 (seeds 0 ... 15), cold and warm
            ``predict_with_uncertainty`` and ``nlml`` with the launches
            against the plan, against a loop of single GPs and each problem
            against a float64 dense solve; fleet.batch.train: ``optimize``
            (3 matern52 steps, (B,) leaves) against float64 dense Adam per
            problem, with a step's forward / K^-1 / contraction split;
            fleet.batch.update: ``update(512)`` then ``forget(512)`` warm
            (carry on B x G tiles) against a cold rebuild;
            fleet.batch.lowrank: ``GPBatch(method="lowrank")`` of 8 problems
            of n = 32768, m_inducing 1024, against a float64 dense DTC each;
            fleet.ragged: ``GPFleet`` of 32 sizes log-uniform in [512,
            16384] (fig11's skewed mix), pow2 buckets, cold calls and
            ``predict_each`` against single GPs, the smallest and largest
            problem of each bucket against float64, then ragged arrivals that
            migrate two problems, warm, against a cold rebuild;
            fleet.ragged.lowrank: ``GPFleet(method="lowrank")`` of 16 sizes
            log-uniform in [512, 65536], m_inducing 1024, cold and warm
            ``predict_with_uncertainty`` with the launches against the
            buckets' plans, beside a loop of single low-rank GPs, each
            problem against a float64 dense DTC on its own inducing points,
            then a migrating update on a pinned inducing set (every bucket
            warm, chol(B) alone, against a cold rebuild), with peak memory;
            fleet.ragged.lowrank.kernels: each kernel's widest launch of the
            cold call and the update against its plain version;
            serve.fleet: ``ContinuousBatcher`` over fleet.ragged's exact
            fleet and the low-rank one, 6 waves of 64 predictions and 8
            observations, every result bitwise against a synchronous
            ``predict_each`` on the wave's snapshot, per-wave host seconds
            beside device ms, p50/p99 latency, one drift-triggered
            re-optimize on the low-rank fleet, the fleets after the waves
            against cold ones, and gp_16k's cold ``predict`` with telemetry
            on and off (bitwise equal, overhead in ms);
            timing.fleet and profile.fleet*: cold calls beside their loops,
            in turns, and one cold call of each under ``torch.profiler``;
12. kernel.flash  the flash-attention kernel at gemma2-2b's prefill shape
            (B = 4, S = T = 2048, 8 query heads on 4 KV heads, hd = 256,
            softcap 50, bf16) against its plain version, plus the local
            window at S = 8192, a ragged S and float32; times it beside
            ``scaled_dot_product_attention``; fails on a spill in any
            instantiation, on a bf16 one without HGMMA, or on ptxas
            serializing its wgmma; kernel.flash.recurrentgemma: the launch of
            recurrentgemma-2b's local layers (B = 4, S = T = 2048, 10 query
            heads on one KV head, hd 256, window 2048, no softcap, bf16)
            against its plain version, timed beside its bound and SDPA
            under the same windowed causal mask; kernel.flash.lm_shapes (17);
13. lm      gemma2-2b at full width (26 layers, d_model 2304, bf16, random
            weights from the seed) serves two batches, 4 prompts of 2048
            tokens and 1 of 8192, each a prefill (``cache_len`` = S + 16)
            and 16 greedy decode steps, with the flash launches counted (26
            per prefill, none per step); decoded logits are held against a
            full forward over the same tokens, in bf16 and with the weights
            cast to float32;
14. timing.lm, profile.lm  prefill seconds and tokens/s, decode ms per
            step, peak memory; one prefill and one decode step under
            ``torch.profiler`` (flash and matmul shares, idle share; a
            prefill that profiles 0 ms of flash fails);
15. lm.train  gemma2-2b at full width, bf16, seeded weights: three Adam
            (cosine warmup) steps of make_train_step on token_batches(V, 2,
            2048), losses, step seconds, tokens/s, peak memory and flash
            launches a step (26 forward + 26 recomputed); step 0's loss
            against a float32 forward on the same weights (2e-2 relative);
            profile.lm.train: one step under torch.profiler and its parts;
            lm.train.grad: the 2-layer cut's float32 gradients on the card
            against the CPU's and its bf16 ones against its float32 ones;
            lm.trainer: the Trainer at that cut, asynchronous checkpoints
            every 2 of 6 steps, a second Trainer resumed from them, its
            losses against the uninterrupted run's (1e-5 relative);
            lm.mesh, a world of 4 ranks spawned to run beside those two:
            olmo-1b at full width, depth 2, float32, 4 x 512 tokens on a
            2 x 2 ("data", "model") mesh, one sharded make_train_step step
            against the unsharded one, each rank's bytes against its
            blocks, the compressed data-parallel step on ("pod", "data")
            against the plain step (the reference's rule), prefill and 4
            decode steps under the mesh, a checkpoint of the sharded state
            restored on one device bitwise; collectives, seconds and peak
            memory by rank; lm.train.total against its 90 s budget.
16. lm.recurrent  the recurrent layer kinds at full width and depth, bf16,
            seeded weights: recurrentgemma-2b (26 layers: 18 rglru, 8 local)
            and mamba2-1.3b (48 mamba2 layers).  lm.recurrent.serve: each
            serves LM_BATCHES as lm does, every launch counted (flash 8
            times a recurrentgemma prefill, never in a step; none for
            mamba2), prefill seconds, decode ms a step, peak memory;
            lm.recurrent.decode_vs_full_forward: LM_RULE at tokens S and
            S + 15; profile.lm.recurrent: one 4 x 2048 prefill of each under
            torch.profiler (top kernels, idle share) and the linear scan
            alone at its shapes; lm.recurrent.train: two Adam steps of each
            on token_batches(V, 2, 2048), losses near ln V, step 0 within 2e-2
            of a float32 forward, 16 flash launches a recurrentgemma step;
            lm.recurrent.grad: float32 gradients, card against CPU, at
            depth 3 (recurrentgemma, one pattern cycle) and 2 (mamba2), full
            width, 1 x 512 tokens; lm.recurrent.total against its 90 s
            budget (the profiles not counted).
17. lm.moe, lm.embed  the MoE feed-forward and the embeddings input at full
            width, bf16, seeded weights (kernel.flash.lm_shapes, in phase 12:
            the flash kernel at each new model's 4 x 2048 prefill, 64 on 4
            heads of 128, 56 on 8 and 32 on 32 of 64, beside SDPA).
            lm.moe.serve: qwen3-moe-235b-a22b (depth 94 -> 8) and
            arctic-480b (depth 35 -> 2) serve LM_BATCHES, flash once an
            attention layer a prefill, with each layer's dropped choices and
            busiest expert; lm.embed.serve: llava-next-34b and musicgen-large
            whole, prompts of seeded normal (B, S, d) embeddings, the decoded
            tokens through embed; *.decode_vs_full_forward: the bf16 decode at
            the served depth beside its drops, and LM_RULE on a float32 model
            at depth 1 (the MoE models, capacity factor 8), 4 (llava) or whole
            (musicgen); profile.lm.moe: one qwen3-moe prefill under
            torch.profiler and the MoE's parts by CUDA events;
            lm.moe.train (qwen3-moe, depth 1) and lm.embed.train (musicgen):
            two Adam steps each; lm.moe.grad (one qwen3-moe block, 0 routing
            flips) and lm.embed.grad (musicgen, depth 2): float32 gradients,
            card against CPU; lm.arch.total against its 120 s budget.
18. launch  the launch tools (repro_torch.launch).  launch.card: gemma2-2b at
            full width, bf16, at world 1: a 4 x 2048 prefill and a 2 x 2048
            Adam step (as lm.serve and lm.train run them) on the card under
            launch.analysis.measure, against the same steps on meta tensors:
            FLOPs equal, the launches the meta run counts equal to those the
            card counts and really makes, the dry-run's peak bytes within 15% of
            torch.cuda.max_memory_allocated, the measured seconds at least
            the compute term, and the measured time over each term;
            launch.dryrun, two spawned processes beside it, each rank 0 of a
            fake world: gemma2-2b's train_4k, prefill_32k and decode_32k and
            gp_256k on the (16, 16) mesh, gp_512k on (2, 16, 16), each
            record's FLOPs, bytes and wire bytes a rank, peak bytes,
            fits_80gb and roofline terms on H100_SXM; launch.dist: the
            dry-run of gp_dist_32k on a fake 2 x 2 mesh against dist.predict's
            rank 0 (collectives by op equal; the launches the dry-run counts
            equal to the schedule's and to those rank 0 made on the card);
            launch.total against its 90 s budget.
            ``--only-launch`` runs env, build, the multi-device phases and
            these alone.
19. examples  the five entry points a user runs (examples_torch/), through
            their own functions with the arguments their command lines and
            docstrings give, launches counted by example:
            examples.gp_system_identification at gp_16k (n 16384, tile 512,
            n̂ 512) on the MSD data, mean and variance by the GP accuracy
            rule and the tiled mean against the monolithic one it prints;
            examples.quickstart and examples.composite_workload at their
            defaults, the untrained predictions by the same rule and the
            trained parameters within 2e-2 of the same run on the CPU;
            examples.serve_gp.{single,fleet,online,ragged} at the sizes of
            the example's docstring (ragged also with --metrics), p50/p99
            and req/s, each mode's served predictions of one batch bitwise
            against a synchronous call on the same state;
            examples.train_lm: olmo-1b at full width, 3 steps of 8 x 128,
            losses, median step and peak memory; examples.train_lm.resume:
            the command line at --size 100m killed (SIGKILL) after its log
            line at step 10 (checkpoints every 4, run beside the MSD data),
            rerun: resumed from the last saved step, its losses within 1e-5
            of an uninterrupted run's; examples.total against its 120 s
            budget;
20. train.kinv  K^-1 of gp_16k's first matern52 training step by
            triangular.kinv_tiles_from_factor (the reference's route) beside
            torch.cholesky_inverse (the port's): CUDA-event times, each
            route's error against a float64 cholesky_inverse of the same
            factor, and the blocked rule's gradient from each, per component
            against float64 dense autograd (reported; neither must win).
            ``--only-examples`` runs env, build and phases 19-20 alone.

Every phase prints one JSON line.  The kernels' summary, the nvidia-smi line
and, last, ``{"ok": true, "device": {...}}`` follow.  Any failed check exits
non-zero before the last line; so does a machine without CUDA, or a directory
that holds this script without the package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# gp_16k (src/repro/configs/gp_msd.py): n_train = n_test = 16384, tile 512
N_TRAIN = N_TEST = 16384
TILE = 512
N_FEATURES = 16
SEED = 0

# kernels of the main path (cold/warm prediction), the update path and the low-rank path
MAIN_KERNELS = ("cov_tiles", "potrf", "trsm", "trail")
UPDATE_KERNELS = MAIN_KERNELS + ("carry_update",)
LOWRANK_KERNELS = MAIN_KERNELS + ("lrgemm",)
VECTOR_KERNELS = ("tile_gemv", "tile_trsv")  # the fleets' batch-invariant matvec and solve
NO_LAUNCHES = {k: 0 for k in UPDATE_KERNELS + ("lrgemm", "flash_attention") + VECTOR_KERNELS}
# the sliding-window path: a window of N_TRAIN rows, UPDATE_STEPS steps of one tile
UPDATE_STEPS = 2
# a carry tile past the tallest strip (32 rows float32, 16 float64: m <= 1472 / 1440)
CARRY_BIG_M = 2048
# gp_256k_lowrank: gp_256k's sizes (src/repro/configs/gp_msd.py:19) on the
# Nystrom tier, m_inducing = 2048 (4 tiles), subset inducing points, jitter 1e-4
LR_N_TRAIN = 262144
LR_N_TEST = 16384
LR_M_INDUCING = 2048
LR_STEPS = 2

# gemma2-2b (src/repro/configs/gemma2_2b.py) at full width, bf16, random
# weights from SEED: the served batches are (requests, prompt tokens), one
# below the local window of 4096 and one above it; each prompt is followed
# by LM_STEPS greedy decode steps
LM_ARCH = "gemma2-2b"
LM_BATCHES = ((4, 2048), (1, 8192))
LM_STEPS = 16
# phase kernel.flash, at gemma2-2b's heads (8 on 4 KV heads, hd 256, softcap
# 50): name -> (B, S = T, type, local window?, q scale, tolerance); the first
# is the served prefill's attention, the one the kernels line reports
FLASH_CASES = {
    "served_b4_s2048": (4, 2048, torch.bfloat16, False, 1.0, 2e-2),
    "local_b1_s8192_w4096": (1, 8192, torch.bfloat16, True, 1.0, 2e-2),
    "ragged_b2_s1000": (2, 1000, torch.bfloat16, False, 1.0, 2e-2),
    "float32_b1_s1024_qx20": (1, 1024, torch.float32, False, 20.0, 5e-5),
}

# the recurrent layer kinds (lm.recurrent.*): recurrentgemma-2b (rglru and local attention) and mamba2-1.3b at full
# width and depth, bf16, seeded weights, served as LM_ARCH is (LM_BATCHES, LM_STEPS) and trained for
# LM_REC_TRAIN_STEPS Adam steps on token_batches(V, LM_TRAIN_B, LM_TRAIN_S); the gradient check cuts their depth
# to one pattern cycle of recurrentgemma (rglru, rglru, local) and two mamba2 layers
LM_REC_ARCHS = ("recurrentgemma-2b", "mamba2-1.3b")
LM_REC_CUT = {"recurrentgemma-2b": 3, "mamba2-1.3b": 2}
LM_REC_TRAIN_STEPS = 2
LM_REC_LOSS_RTOL = 0.1        # a step's loss within 10% of ln V: random weights predict a near-uniform next token
LM_REC_BUDGET_S = 90.0        # the recurrent phases' share of the script's wall time
# kernel.flash at recurrentgemma-2b's local layers: (arch, B, S = T)
LM_REC_FLASH = ("recurrentgemma-2b", 4, 2048)

# the flash kernels' names in a profile (the bf16 kernel of the served path, and float32)
FLASH_KERNEL_NAMES = ("flash_wgmma_kernel", "flash_f32_kernel")

# Published peaks of one H100 SXM (dense, at the 700 W limit): FP32 on the
# CUDA cores, bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time a call of ``fn`` in ms: its CUDA kernels' time under ``torch.profiler`` over ``reps``
    calls.  For launches shorter than their host-side cost, where CUDA events around back-to-back calls (cuda_ms)
    time the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total > 0, "device_ms: the profiler saw no device time")
    return total / reps / 1e3


def wall_s(fn):
    """(result, seconds) of ``fn`` on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(n_bytes: float, n_ops: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(least time in ms, what bounds it) at the card's published peaks (FP32 unless given)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.ndim > 1 and a.numel() > 2**26:  # in slices along the first axis: the float64 copies stay small
        step = max(1, 2**26 // a[0].numel())
        return max(max_err(u, v) for u, v in zip(a.split(step), b.split(step)))
    return float((a.double() - b.double()).abs().max())


def make_data(n_train: int, n_test: int, d: int, seed: int):
    """NFIR windows of a smoothed random force, with a non-linear target.

    Scaled as ``data/msd.make_dataset`` scales its inputs: the force is
    z-scored with training statistics and divided by sqrt(2 D), so the SE
    kernel's l = 1 sees O(1) squared distances; targets are z-scored.  The
    target is a fixed hardening response of the windowed force plus noise
    (instead of the RK4 simulation, whose Python loop takes minutes here).
    """
    rng = np.random.default_rng(seed)

    def force(steps):
        e = rng.normal(0.0, 4.0, steps)
        u = np.empty(steps)
        acc = 0.0
        for t in range(steps):  # low-pass smoothing, cutoff 0.25
            acc = 0.75 * acc + 0.25 * e[t]
            u[t] = acc
        return u

    u_tr, u_te = force(n_train + d - 1), force(n_test + d - 1)
    mu, f_sd = u_tr.mean(), u_tr.std() * np.sqrt(2.0 * d)
    impulse = np.exp(-np.arange(d) / 4.0)

    def windows(u):
        x = np.lib.stride_tricks.sliding_window_view((u - mu) / f_sd, d)[:, ::-1]
        lin = x @ impulse
        y = lin + 0.5 * np.tanh(3.0 * lin) + 0.3 * lin**3
        return np.ascontiguousarray(x), y + rng.normal(0.0, 0.05 * y.std(), y.shape)

    x_tr, y_tr = windows(u_tr)
    x_te, y_te = windows(u_te)
    y_mu, y_sd = y_tr.mean(), y_tr.std()
    return (
        x_tr.astype(np.float32),
        ((y_tr - y_mu) / y_sd).astype(np.float32),
        x_te.astype(np.float32),
        ((y_te - y_mu) / y_sd).astype(np.float32),
    )


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build

    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    emit(
        "env",
        nvidia_smi=smi,
        device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(),
        torch=torch.__version__,
        torch_cuda=torch.version.cuda,
        nvcc=nvcc,
        python=sys.version.split()[0],
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
    )
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [l.strip() for l in _build.build_log(name).splitlines() if "Used" in l or "spill" in l]
        for name in _build.SOURCES
    }
    emit("build", seconds=seconds, libraries={k: str(p.relative_to(ROOT)) for k, p in paths.items()},
         ptxas=ptxas)


def kernel_phases(x_train: np.ndarray, x_test: np.ndarray, dev: torch.device):
    """Each kernel against its plain version on the main path's tiles."""
    from repro_torch.core import executor, kernels_math as km, scheduler as sch, tiling
    from repro_torch.kernels import cov_assembly, ops, potrf_tile, trailing_update, trsm_tile

    params = km.SEKernelParams.paper_defaults()
    m, d = TILE, N_FEATURES
    xc = tiling.pad_features(torch.from_numpy(x_train).to(dev), m)
    m_tiles = xc.shape[0]
    plan = executor.program_plan(m_tiles, m_tiles, False, None)
    rows = {}
    f32 = torch.float32

    # --- cov_tiles: the ASSEMBLE launch (level 0, every packed tile) -------
    asm = next(b for lvl in plan.levels for b in lvl if b.op == sch.ASSEMBLE)
    ra, rb = (torch.from_numpy(a).to(dev) for a in (asm.a, asm.b))
    xa, xb, r0, c0 = xc[ra], xc[rb], ra * m, rb * m
    n = x_train.shape[0]

    table = ops.cov_descriptor(None, params, d, torch.float32, dev)  # built once a run, as the executor builds it

    def cov_k():
        return ops.cov_tiles(xa, xb, r0, c0, n, n, params, symmetric=True, table=table)

    def cov_p():
        return cov_assembly.cov_tiles_plain(xa, xb, r0, c0, n, n, params, symmetric=True)

    k_tiles = cov_k()
    torch.cuda.synchronize()
    err = max_err(k_tiles, cov_p())
    diag = torch.diagonal(k_tiles[torch.from_numpy(asm.a == asm.b).to(dev)], dim1=-2, dim2=-1)
    diag_exact = bool((diag == torch.tensor(1.1, dtype=f32, device=dev)).all())
    # the cross form (zero padding) on a ragged frontier, as CROSS/PRIOR use it
    cross_err = max_err(
        ops.cov_tiles(xa, xb, r0, c0, n - 300, n - 7, params, symmetric=False),
        cov_assembly.cov_tiles_plain(xa, xb, r0, c0, n - 300, n - 7, params, symmetric=False),
    )
    tol = 1e-5
    t = len(asm.tasks)
    b, mb = k_tiles.shape[0], k_tiles.shape[2]
    nbytes = (xa.numel() + xb.numel() + 4 * t + k_tiles.numel()) * 4
    nops = t * (2 * d * m * mb + 2 * d * (m + mb) + 6 * m * mb)
    bnd = bound_ms(nbytes, nops)
    rows["cov_tiles"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/cov_assembly.cu",
        replaces="src/repro/kernels/cov_assembly.py:36", max_abs_err=max(err, cross_err),
        ms=cuda_ms(cov_k, 10), plain_ms=cuda_ms(cov_p, 3), bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=None,
    )
    emit("kernel.cov_tiles", shape=[t, m, m, d], max_abs_err=err, cross_max_abs_err=cross_err,
         tol=tol, tol_reason="same float32 formula; exp and the D=16 dot product round "
         "in another order (values <= v + sigma^2 = 1.1)", diag_bitwise_v_plus_noise=diag_exact,
         **{k: rows["cov_tiles"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    check(err <= tol and cross_err <= tol, f"cov_tiles disagrees with its plain version: {err}, {cross_err}")
    check(diag_exact, "cov_tiles: global diagonal is not bitwise v + sigma^2")
    cov_extra(plan, xc, x_test, params, n, tol, dev)

    # --- potrf: the first diagonal tile, G = 1 as the program issues it ---
    packed = torch.zeros_like(k_tiles)
    packed.index_copy_(0, torch.from_numpy(asm.out).to(dev), k_tiles)
    a00 = packed[0:1].contiguous()
    l00 = ops.potrf(a00)
    torch.cuda.synchronize()
    err = max_err(l00, potrf_tile.potrf_plain(a00))
    tol = 1e-4 * m
    nbytes, nops = 2 * a00.numel() * 4, m**3 / 3
    bnd = bound_ms(nbytes, nops)
    rows["potrf"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/potrf_tile.cu",
        replaces="src/repro/kernels/potrf_tile.py:23", max_abs_err=err,
        ms=cuda_ms(lambda: ops.potrf(a00), 10), plain_ms=cuda_ms(lambda: potrf_tile.potrf_plain(a00), 2),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(a00), 10),
    )
    emit("kernel.potrf", shape=list(a00.shape), max_abs_err=err, tol=tol,
         tol_reason="the reference's test_potrf_shapes tolerance (1e-4 m); blocked kernel "
         "against the unblocked plain loop", **{k: rows["potrf"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    check(err <= tol, f"potrf disagrees with its plain version: {err}")
    diag_pos = torch.from_numpy(asm.out[asm.a == asm.b][np.argsort(asm.a[asm.a == asm.b])]).to(dev)
    potrf_cases(a00, packed[diag_pos[1:]], x_train, params, dev)

    # --- trsm: the panel of column 0 (31 tiles), one L per task ---------
    trsm_b = next(b for lvl in plan.levels for b in lvl if b.op == sch.TRSM)
    packed[0] = l00[0]
    bidx = torch.from_numpy(trsm_b.b).to(dev)
    l_stack = packed[torch.from_numpy(trsm_b.a).to(dev)]
    b_stack = packed[bidx]
    x_panel = ops.trsm(l_stack, b_stack)
    torch.cuda.synchronize()
    err = max_err(x_panel, trsm_tile.trsm_plain(l_stack, b_stack))
    tol = 1e-3
    g = b_stack.shape[0]
    bnd = bound_ms(3 * b_stack.numel() * 4, g * m**3)
    rows["trsm"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/trsm_tile.cu",
        replaces="src/repro/kernels/trsm_tile.py:22", max_abs_err=err,
        ms=cuda_ms(lambda: ops.trsm(l_stack, b_stack), 10),
        plain_ms=cuda_ms(lambda: trsm_tile.trsm_plain(l_stack, b_stack), 2),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(
            lambda: torch.linalg.solve_triangular(l_stack.mT, b_stack, upper=True, left=False), 10
        ),
    )
    emit("kernel.trsm", shape=list(b_stack.shape), max_abs_err=err, tol=tol,
         tol_reason="the reference's float32 trsm tolerance (test_trsm_shapes)",
         **{k: rows["trsm"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    check(err <= tol, f"trsm disagrees with its plain version: {err}")
    trsm_extra(l_stack, b_stack, x_train, x_test, params, tol, dev)

    # --- trail: the fused SYRK+GEMM launch of column 0 (496 tiles) -------
    packed.index_copy_(0, bidx, x_panel)
    tr = next(b for lvl in plan.levels for b in lvl if b.op == executor.TRAIL)
    c_s, a_s, b_s = (packed[torch.from_numpy(i).to(dev)] for i in (tr.a, tr.b, tr.c))
    out = ops.trail(c_s, a_s, b_s)
    torch.cuda.synchronize()
    err = max_err(out, trailing_update.trail_plain(c_s, a_s, b_s))
    bf = torch.bfloat16
    err_bf16 = max_err(ops.trail(c_s, a_s, b_s, bf), trailing_update.trail_plain(c_s, a_s.to(bf), b_s.to(bf)))
    tol = 1e-3
    g = c_s.shape[0]
    bnd = bound_ms(4 * c_s.numel() * 4, 2 * g * m**3)
    rows["trail"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/trailing_update.cu",
        replaces="src/repro/kernels/trailing_update.py:30", max_abs_err=max(err, err_bf16),
        ms=cuda_ms(lambda: ops.trail(c_s, a_s, b_s), 5),
        plain_ms=cuda_ms(lambda: trailing_update.trail_plain(c_s, a_s, b_s), 5),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(lambda: torch.baddbmm(c_s, a_s, b_s.mT, alpha=-1), 5),
    )
    emit("kernel.trail", shape=list(c_s.shape), max_abs_err=err, bf16_max_abs_err=err_bf16,
         tol=tol, tol_reason="float32 accumulation in another order (K = 512) on both sides; "
         "bf16 operands are rounded identically on both sides",
         bf16_ms=cuda_ms(lambda: ops.trail(c_s, a_s, b_s, bf), 5),
         **{k: rows["trail"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    check(err <= tol and err_bf16 <= tol, f"trail disagrees with its plain version: {err}, {err_bf16}")
    trail_extra(c_s, a_s, b_s, rows["trail"]["ms"], rows["trail"]["library_ms"], tol, m_tiles, dev)

    # --- float64 and ragged edges (m not a multiple of any block) --------
    gen = torch.Generator().manual_seed(SEED)
    edge = {}
    for dt, mm, tol in ((torch.float64, 64, 1e-10), (torch.float64, 100, 1e-10), (f32, 100, 1e-3)):
        r = torch.randn(3, mm, mm, generator=gen, dtype=dt).to(dev)
        spd = r @ r.mT / mm + torch.eye(mm, dtype=dt, device=dev)
        lo = potrf_tile.potrf_plain(spd)
        rhs = torch.randn(3, mm, mm, generator=gen, dtype=dt).to(dev)
        e = {
            "potrf": max_err(ops.potrf(spd), lo),
            "trsm": max_err(ops.trsm(lo, rhs), trsm_tile.trsm_plain(lo, rhs)),
            "trail": max_err(ops.trail(spd, lo, rhs), trailing_update.trail_plain(spd, lo, rhs)),
        }
        xs = torch.randn(3, mm, 3, generator=gen, dtype=dt).to(dev)
        for sym in (True, False):
            e[f"cov_sym{int(sym)}"] = max_err(
                ops.cov_tiles(xs, xs, 0, 0, mm - 5, mm - 9, params, symmetric=sym),
                cov_assembly.cov_tiles_plain(xs, xs, 0, 0, mm - 5, mm - 9, params, symmetric=sym),
            )
        key = f"{str(dt).split('.')[-1]}_m{mm}"
        edge[key] = e
        check(max(e.values()) <= tol * mm, f"{key}: kernel disagrees with its plain version: {e}")
    emit("kernel.edges", errors=edge, tol="1e-10 m (float64), 1e-3 m (float32)",
         tol_reason="3 random SPD tiles; float64 keeps float64 in every kernel")
    torch.cuda.synchronize()
    return rows


def ptxas_report(source: str, label) -> dict:
    """Registers, shared memory and spill bytes of the kernels of ``csrc/<source>.cu``, from the build's
    ``-Xptxas -v``, keyed by ``label(mangled name)`` (kernels it maps to None are left out)."""
    from repro_torch.kernels import _build

    found, current = {}, None
    for line in _build.build_log(source).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = label(entry.group(1))
            if current:
                found[current] = {}
        elif current and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found[current].update(spill_store_bytes=int(st), spill_load_bytes=int(ld))
            frame = re.search(r"(\d+) bytes stack frame", line)
            if frame:
                found[current]["stack_frame_bytes"] = int(frame.group(1))
        elif current and "registers" in line:
            found[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            found[current]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return found


def potrf_ptxas() -> dict:
    """ptxas report of each ``potrf_kernel``, keyed by type."""
    return ptxas_report("potrf_tile", lambda name: "float32" if "potrf_kernelIf" in name
                        else "float64" if "potrf_kernelId" in name else None)


_TYPES = {"ff": "float32", "dd": "float64", "13__nv_bfloat16f": "bf16", "f": "float32", "d": "float64"}


def trail_label(name: str):
    """'float32/big/vec' for trail_kernel<float, float, 16, 16, V = 4, 8, VEC = true, 2>, and so on."""
    k = re.search(r"trail_kernelI(ff|dd|13__nv_bfloat16f)Li\d+ELi\d+ELi(\d+)ELi\d+ELb([01])E", name)
    if not k:
        return None
    big = int(k.group(2)) == (2 if k.group(1) == "dd" else 4)
    return f"{_TYPES[k.group(1)]}/{'big' if big else 'small'}/{'vec' if k.group(3) == '1' else 'scalar'}"


def carry_label(name: str):
    """'float32/rs32/vec' for carry_kernel<float, 32, true>, 'float32/prep' for strip::prep<float>."""
    k = re.search(r"carry_kernelI([fd])Li(\d+)ELb([01])E", name)
    if k:
        return f"{_TYPES[k.group(1)]}/rs{k.group(2)}/{'vec' if k.group(3) == '1' else 'scalar'}"
    k = re.search(r"5strip4prepI([fd])E", name)
    return f"{_TYPES[k.group(1)]}/prep" if k else None


def flash_label(name: str):
    """'bf16/hd256' for flash_wgmma_kernel<256>, 'float32/hd64' for flash_f32_kernel<64>."""
    k = re.search(r"flash_(wgmma|f32)_kernelILi(\d+)E", name)
    return f"{'bf16' if k.group(1) == 'wgmma' else 'float32'}/hd{k.group(2)}" if k else None


def sass_mma_counts(source: str, label, ops=("HMMA", "HGMMA")) -> dict:
    """Tensor-core instructions (by default HMMA and HGMMA) in the SASS of each labelled kernel of ``csrc/<source>.cu``."""
    from repro_torch.kernels import _build

    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = label(fn.split(None, 1)[0])
        if name:
            counts[name] = sum(len(re.findall(rf"\b{op}\b", fn)) for op in ops)
    return counts


def check_build_quality(kernel: str, ptxas: dict, mma: dict) -> None:
    """The float32 instantiations build without spills and issue no tensor-core instruction."""
    f32 = {k: v for k, v in ptxas.items() if k.startswith("float32")}
    check(f32 and all(v.get("spill_store_bytes") == 0 and v.get("spill_load_bytes") == 0 for v in f32.values()),
          f"{kernel}: ptxas reports spills in a float32 instantiation: {f32}")
    f32_mma = {k: n for k, n in mma.items() if k.startswith("float32")}
    check(f32_mma and not any(f32_mma.values()), f"{kernel}: HMMA/HGMMA in the float32 SASS: {f32_mma}")


def trail_extra(c_s, a_s, b_s, ms, library_ms, tol, m_tiles, dev):
    """TRAIL's rate at the 496-tile launch, its append launches beside baddbmm, ptxas and SASS.

    Each append launch is held against ``trail_plain`` at ``tol``, kernel.trail's tolerance: at
    G < 66 they run the 64 x 64 instantiation, which the 496-tile launch does not.
    """
    from repro_torch.core import executor
    from repro_torch.kernels import _build, trailing_update

    g, m = c_s.shape[0], c_s.shape[1]
    append = executor.update_append_plan(m_tiles, m_tiles)
    sizes = sorted({b.size for lvl in append.levels for b in lvl if b.op in ("ugemm", "usyrk")})
    launches = {}
    for gs in (sizes[0], sizes[len(sizes) // 2], sizes[-1]):
        cs, as_, bs_ = (t[:gs].contiguous() for t in (c_s, a_s, b_s))
        err = max_err(trailing_update.trail_cuda(cs, as_, bs_), trailing_update.trail_plain(cs, as_, bs_))
        t_k = cuda_ms(lambda: trailing_update.trail_cuda(cs, as_, bs_), 20)
        t_l = cuda_ms(lambda: torch.baddbmm(cs, as_, bs_.mT, alpha=-1), 20)
        launches[f"G{gs}"] = {"variant_big_vec": trailing_update.trail_variant(gs, m, torch.float32),
                              "max_abs_err": err, "tol": tol, "ms": t_k,
                              "library_ms": t_l, "tflops": 2 * gs * m**3 / t_k / 1e9,
                              "bound_ms": bound_ms(4 * cs.numel() * 4, 2 * gs * m**3)[0]}
    lib = _build.load("trailing_update")
    ptxas, mma = ptxas_report("trailing_update", trail_label), sass_mma_counts("trailing_update", trail_label)
    emit("kernel.trail.extra", shape=list(c_s.shape), tflops=2 * g * m**3 / ms / 1e9,
         library_tflops=2 * g * m**3 / library_ms / 1e9, variant_big_vec=trailing_update.trail_variant(g, m, torch.float32),
         ctas_per_sm={"big": lib.trail_f32_ctas_per_sm(1), "small": lib.trail_f32_ctas_per_sm(0)},
         append_launch_sizes=sizes, append_launches=launches, ptxas=ptxas, sass_hmma_count=mma,
         library_call="torch.baddbmm(C, A, B^T, alpha=-1) (cuBLAS, IEEE float32)")
    check_build_quality("trail", ptxas, mma)
    check(all(v["max_abs_err"] <= tol for v in launches.values()),
          f"trail disagrees with its plain version at an append launch size: {launches}")


def cov_label(name: str):
    """'float32/vec/iso' for cov_tiles_kernel<float, VEC = true, ARD = false>, and so on."""
    k = re.search(r"cov_tiles_kernelI([fd])Lb([01])ELb([01])E", name)
    if not k:
        return None
    return f"{_TYPES[k.group(1)]}/{'vec' if k.group(2) == '1' else 'scalar'}/{'ard' if k.group(3) == '1' else 'iso'}"


def cov_extra(plan, xc, x_test, params, n, tol, dev):
    """cov_tiles at the CROSS launch of gp_16k's cold call (1024 tiles), its ptxas and SASS."""
    from repro_torch.core import scheduler as sch, tiling
    from repro_torch.kernels import _build, cov_assembly, ops

    m, d = TILE, N_FEATURES
    cross = next(b for lvl in plan.levels for b in lvl if b.op == sch.CROSS)
    xtc = tiling.pad_features(torch.from_numpy(x_test).to(dev), m)
    ra, rb = (torch.from_numpy(a).to(dev) for a in (cross.a, cross.b))
    xa, xb, r0, c0 = xtc[ra], xc[rb], ra * m, rb * m
    nt = x_test.shape[0]

    table = ops.cov_descriptor(None, params, d, torch.float32, dev)

    def cross_k():
        return ops.cov_tiles(xa, xb, r0, c0, nt, n, params, symmetric=False, table=table)

    got = cross_k()
    torch.cuda.synchronize()
    err = max_err(got, cov_assembly.cov_tiles_plain(xa, xb, r0, c0, nt, n, params, symmetric=False))
    t = xa.shape[0]
    bnd = bound_ms((xa.numel() + xb.numel() + 4 * t + got.numel()) * 4, t * (2 * d * m * m + 2 * d * 2 * m + 6 * m * m))
    del got
    ms = cuda_ms(cross_k, 10)
    ptxas, mma = ptxas_report("cov_assembly", cov_label), sass_mma_counts("cov_assembly", cov_label)
    emit("kernel.cov_tiles.extra", cross_shape=[t, m, m, d], cross_max_abs_err=err, tol=tol, cross_ms=ms,
         cross_bound_ms=bnd[0], cross_bound_by=bnd[1], cross_tb_per_s=t * m * m * 4 / ms / 1e9,
         ptxas=ptxas, ptxas_lines=[l.strip() for l in _build.build_log("cov_assembly").splitlines() if "Used" in l or "spill" in l],
         sass_hmma_count=mma)
    check(err <= tol, f"cov_tiles disagrees with its plain version at the CROSS launch: {err}")
    check(set(ptxas) == {f"{t}/{v}/{a}" for t in ("float32", "float64") for v in ("vec", "scalar")
                         for a in ("iso", "ard")},
          f"cov_tiles: unexpected kernels in the ptxas report: {sorted(ptxas)}")
    check_build_quality("cov_tiles", ptxas, mma)


def trsm_label(name: str):
    """'float32/rs8/d32/vec' for trsm_kernel<float, 8, 32, true>, 'float32/prep' for strip::prep<float>."""
    k = re.search(r"trsm_kernelI([fd])Li(\d+)ELi(\d+)ELb([01])E", name)
    if k:
        return f"{_TYPES[k.group(1)]}/rs{k.group(2)}/d{k.group(3)}/{'vec' if k.group(4) == '1' else 'scalar'}"
    k = re.search(r"5strip4prepI([fd])E", name)
    return f"{_TYPES[k.group(1)]}/prep" if k else None


def trsm_extra(l_stack, b_stack, x_train, x_test, params, tol, dev):
    """TRSM at the path's other launch sizes, each beside ``torch.linalg.solve_triangular``.

    G = 1 (a sliding-window step's UTRSM launches, 32 a step); the cold
    call's 31 launches, G = 31, 30, ..., 1, summed; gp_32k's tile, m = 1024
    (src/repro/configs/gp_msd.py:12), at G = 1 and at its first panel, G =
    31, from NFIR rows of the data; float64 at G = 31.  With each launch's
    strip, and the ptxas registers and spills and the SASS's tensor-core
    instructions of the prep and solve kernels.
    """
    from repro_torch.core import tiling
    from repro_torch.kernels import _build, cov_assembly, ops, trsm_tile

    lib = _build.load("trsm_tile")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def lib_solve(l, b):
        return torch.linalg.solve_triangular(l.mT, b, upper=True, left=False)

    def case(l, b, reps, tol_case):
        g, m = b.shape[0], b.shape[1]
        f64 = b.dtype == torch.float64
        err = max_err(ops.trsm(l, b), trsm_tile.trsm_plain(l, b))
        bnd = bound_ms(3 * b.numel() * b.element_size(), g * m**3)
        rs = lib.trsm_strip(g, m, int(f64), sms)
        return dict(shape=list(b.shape), dtype=str(b.dtype).split(".")[-1], strip_rows=rs,
                    stage_rows=lib.trsm_depth(rs, m, int(f64)),
                    ctas=g * -(-m // rs), max_abs_err=err, tol=tol_case,
                    ms=cuda_ms(lambda: ops.trsm(l, b), reps), library_ms=cuda_ms(lambda: lib_solve(l, b), reps),
                    bound_ms=bnd[0], bound_by=bnd[1])

    m = b_stack.shape[1]
    cases = {"float32_g1_m512": case(l_stack[:1], b_stack[:1], 20, tol)}
    cases["float64_g31_m512"] = case(l_stack.double(), b_stack.double(), 5, 1e-10 * m)
    # gp_32k's first panel: 32 tiles of 1024 NFIR rows, the diagonal tile's factor and 31 tiles below it
    m2 = 2 * TILE
    x_all = torch.from_numpy(np.concatenate([x_train, x_test])).to(dev)
    n_all = x_all.shape[0]
    xc2 = tiling.pad_features(x_all, m2)
    l2 = torch.linalg.cholesky(cov_assembly.cov_tiles_plain(xc2[:1], xc2[:1], 0, 0, n_all, n_all, params,
                                                            symmetric=True))
    g2 = xc2.shape[0] - 1
    row0 = torch.arange(1, g2 + 1, device=dev) * m2
    b2 = cov_assembly.cov_tiles_plain(xc2[1:], xc2[:1].expand(g2, m2, -1), row0, 0, n_all, n_all, params,
                                      symmetric=True)
    l2 = l2.expand(g2, m2, m2).contiguous()
    cases["float32_g1_m1024"] = case(l2[:1], b2[:1], 10, tol)
    cases[f"float32_g{g2}_m1024"] = case(l2, b2, 5, tol)
    del l2, b2, xc2
    # the cold call's panels: G = 31, 30, ..., 1 tiles of m = 512
    sweep = {}
    for g in range(b_stack.shape[0], 0, -1):
        l, b = l_stack[:g], b_stack[:g]
        sweep[g] = dict(strip_rows=lib.trsm_strip(g, m, 0, sms), ms=cuda_ms(lambda: ops.trsm(l, b), 10),
                        library_ms=cuda_ms(lambda: lib_solve(l, b), 10),
                        bound_ms=bound_ms(3 * b.numel() * 4, g * m**3)[0])
    cold = {key: sum(v[key] for v in sweep.values()) for key in ("ms", "library_ms", "bound_ms")}
    ptxas, mma = ptxas_report("trsm_tile", trsm_label), sass_mma_counts("trsm_tile", trsm_label)
    emit("kernel.trsm.extra", sms=sms, cases=cases, cold_call_launches=len(sweep), cold_call=cold,
         cold_call_by_g={g: [v["strip_rows"], v["ms"], v["library_ms"]] for g, v in sweep.items()},
         max_m={"float32": lib.trsm_max_m(0), "float64": lib.trsm_max_m(1)}, ptxas=ptxas, sass_hmma_count=mma,
         library_call="torch.linalg.solve_triangular(L^T, B, upper=True, left=False) (cuBLAS)",
         note="cold_call_by_g: G -> [strip rows, ms, library ms]; the bound of each launch is by operations")
    for name, c in cases.items():
        check(c["max_abs_err"] <= c["tol"], f"trsm {name} disagrees with its plain version: {c}")
    check(cases["float32_g1_m512"]["ctas"] >= 64 and sweep[b_stack.shape[0]]["strip_rows"] == 32,
          f"trsm: unexpected strips: G = 1 {cases['float32_g1_m512']}, G = 31 {sweep[b_stack.shape[0]]}")
    check(any(k.endswith("/prep") for k in ptxas), f"trsm: no prep kernel in the ptxas report: {sorted(ptxas)}")
    check_build_quality("trsm", ptxas, mma)
    torch.cuda.synchronize()


def potrf_cases(a00, diag31, x_train, params, dev):
    """The POTRF kernel at the other shapes it meets, each beside ``torch.linalg.cholesky``.

    float64 at m = 512; the 31 other diagonal tiles of gp_16k in one launch
    (G = 31); and one 1024 x 1024 covariance tile, gp_32k's tile width
    (src/repro/configs/gp_msd.py:12).  Also: two calls give bitwise-equal
    factors, a non-positive pivot in the last block column gives NaN where
    the plain loop does, and ptxas reports no spills.
    """
    from repro_torch.kernels import cov_assembly, ops, potrf_tile

    ptxas = potrf_ptxas()
    emit("kernel.potrf.ptxas", kernels=ptxas)
    check(set(ptxas) == {"float32", "float64"}, f"no ptxas report of both potrf_kernel types: {ptxas}")
    check(all(v.get("spill_store_bytes") == 0 and v.get("spill_load_bytes") == 0 for v in ptxas.values()),
          f"potrf_kernel spills: {ptxas}")

    n = x_train.shape[0]
    x1024 = torch.from_numpy(x_train[:1024]).to(dev)[None]
    a1024 = cov_assembly.cov_tiles_plain(x1024, x1024, 0, 0, n, n, params, symmetric=True)
    cases = {
        "float64_g1_m512": (a00.double(), 1e-10),
        "float32_g31_m512": (diag31.contiguous(), 1e-4),
        "float32_g1_m1024": (a1024.contiguous(), 1e-4),
    }
    out = {}
    for name, (a, tol_per_m) in cases.items():
        g, m = a.shape[0], a.shape[1]
        err = max_err(ops.potrf(a), potrf_tile.potrf_plain(a))
        size = 8 if a.dtype == torch.float64 else 4
        # FP64 at the H100's published FP64 tensor-core rate, which equals the FP32 one
        bnd = bound_ms(2 * a.numel() * size, g * m**3 / 3)
        out[name] = dict(shape=list(a.shape), max_abs_err=err, tol=tol_per_m * m,
                         ms=cuda_ms(lambda: ops.potrf(a), 10),
                         plain_ms=cuda_ms(lambda: potrf_tile.potrf_plain(a), 1, warmup=0),
                         library_ms=cuda_ms(lambda: torch.linalg.cholesky(a), 10),
                         bound_ms=bnd[0], bound_by=bnd[1])
    same = {name: bool(torch.equal(ops.potrf(a), ops.potrf(a))) for name, a in
            (("float32_g1_m512", a00), ("float32_g31_m512", cases["float32_g31_m512"][0]))}
    bad = a00.clone()
    bad[0, 500, 500] = -1.0  # the Schur complement at pivot 500 (block column 15 of 16) is negative
    got, want = ops.potrf(bad), potrf_tile.potrf_plain(bad)
    nan_ok = bool(torch.isnan(got[0, 500, 500])) and torch.equal(torch.isnan(got), torch.isnan(want))
    nan_err = max_err(got[0, :500], want[0, :500])
    emit("kernel.potrf.cases", cases=out, bitwise_equal_calls=same, nonpd_pivot_500_nan_as_plain=nan_ok,
         nonpd_rows_above_max_abs_err=nan_err,
         tol_reason="1e-4 m (float32) and 1e-10 m (float64), the reference's test_potrf_shapes "
         "and test_potrf_f64 tolerances per unit of m")
    for name, c in out.items():
        check(c["max_abs_err"] <= c["tol"], f"potrf {name} disagrees with its plain version: {c}")
    check(all(same.values()), f"two potrf calls differ: {same}")
    check(nan_ok and nan_err <= 1e-4 * 512, f"potrf: non-PD pivot 500 not NaN as the plain loop: {nan_err}")
    torch.cuda.synchronize()


GRAD_TOL = 1e-4
GRAD_TOL_F64 = 1e-8


def phase_grad(dev):
    """Gradients through the kernels on the card against the CPU's, and ops without a backward.

    The low-rank NLML of 2048 NFIR rows (m_inducing 256, tile 128) in its
    three hyperparameters, through COV_TILES, POTRF, TRSM, TRAIL and LRGEMM;
    and d log det K / dK through the tiled Cholesky of an SE covariance (n =
    1024, tile 128, noise 0.5, so K is well conditioned).  The float32 rule:
    max |card - cpu| <= 1e-4 max |cpu| over the components.  The NLML's
    smaller components are differences of terms of the largest one's size,
    so their float32 rounding (shown by the CPU's float32 against its
    float64) is set by that size.  Each component on its own is held in
    float64: |card_i - cpu_i| <= 1e-8 max(1, |cpu_i|).
    """
    from repro_torch.core import executor, kernels_math as km, lowrank, tiling, triangular
    from repro_torch.kernels import ops

    x, y, _, _ = make_data(2048, 16, N_FEATURES, SEED)
    x, y = torch.from_numpy(x), torch.from_numpy(y)

    def nlml_grads(device, dtype=torch.float32):
        p = [torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for v in (1.0, 1.0, 0.1)]
        state = lowrank.lowrank_state(x, y, km.SEKernelParams(*p), 256, 128, dtype=dtype, device=device)
        value = lowrank.nlml_from_lowrank_state(state)
        return float(value.detach()), [float(g) for g in torch.autograd.grad(value, p)]

    k = km.assemble_covariance(x[:1024], km.SEKernelParams(1.0, 1.0, 0.5))

    def logdet_grad(device):
        kd = k.to(device).requires_grad_()
        lp = executor.run_cholesky(tiling.pack_lower(kd, 128), device=device)
        value = triangular.logdet_from_factor(lp, 8)
        return float(value.detach()), torch.autograd.grad(value, kd)[0].cpu()

    ops.reset_launch_counts()
    v_card, g_card = nlml_grads(dev)
    launches_nlml = ops.launch_counts()
    v_cpu, g_cpu = nlml_grads("cpu")
    v_card64, g_card64 = nlml_grads(dev, torch.float64)
    v_cpu64, g_cpu64 = nlml_grads("cpu", torch.float64)
    err_i = [abs(a - b) for a, b in zip(g_card, g_cpu)]
    err, scale = max(err_i), max(abs(b) for b in g_cpu)
    err64_i = [abs(a - b) for a, b in zip(g_card64, g_cpu64)]
    tol64_i = [GRAD_TOL_F64 * max(1.0, abs(b)) for b in g_cpu64]
    ops.reset_launch_counts()
    ld_card, gk_card = logdet_grad(dev)
    launches_logdet = ops.launch_counts()
    ld_cpu, gk_cpu = logdet_grad("cpu")
    err_k, scale_k = float((gk_card - gk_cpu).abs().max()), float(gk_cpu.abs().max())
    raised = {}
    w = torch.randn(2, 64, 64, device=dev, requires_grad=True)
    c = torch.eye(64, device=dev).expand(2, 64, 64).contiguous()
    try:
        ops.carry_update(w, w.detach(), w.detach(), c)
        raised["carry_update"] = False
    except RuntimeError as e:
        raised["carry_update"] = "carry_update" in str(e)
    # flash takes gradients since the training path needs them: the kernel forward, the plain version's autograd
    from repro_torch.kernels.flash_attention import flash_attention_plain

    q = torch.randn(1, 128, 2, 64, device=dev, requires_grad=True)
    ops.reset_launch_counts()
    g_flash = torch.autograd.grad(ops.flash_attention(q, q.detach(), q.detach(), softcap=5.0).square().sum(), q)[0]
    flash_launched = ops.launch_counts()["flash_attention"]
    g_plain = torch.autograd.grad(flash_attention_plain(q, q.detach(), q.detach(), softcap=5.0).square().sum(), q)[0]
    flash_grad = dict(launches=flash_launched, max_abs_err=max_err(g_flash, g_plain),
                      tol=1e-4 * max(1.0, float(g_plain.abs().max())))
    emit("grad.card_vs_cpu",
         nlml={"params": ["lengthscale", "vertical", "noise"], "value_card": v_card, "value_cpu": v_cpu,
               "grad_card": g_card, "grad_cpu": g_cpu, "abs_err": err_i, "max_abs_err": err,
               "tol": GRAD_TOL * scale, "cpu_f32_vs_f64_abs_err": [abs(a - b) for a, b in zip(g_cpu, g_cpu64)],
               "launches": launches_nlml},
         nlml_f64={"value_card": v_card64, "value_cpu": v_cpu64, "grad_card": g_card64, "grad_cpu": g_cpu64,
                   "abs_err": err64_i, "tol": tol64_i},
         logdet={"value_card": ld_card, "value_cpu": ld_cpu, "max_abs_err": err_k, "tol": GRAD_TOL * scale_k,
                 "launches": launches_logdet},
         raise_under_grad=raised, flash_under_grad=flash_grad, rule="float32: max |card - cpu| <= 1e-4 max |cpu|; float64, each component: "
         "|card_i - cpu_i| <= 1e-8 max(1, |cpu_i|); the backward differentiates each op's reference "
         "(ops.GRAD_REFS, the plain tile for cov_tiles) on the saved inputs")
    check(all(launches_nlml[k] > 0 for k in ("cov_tiles", "potrf", "trsm", "trail", "lrgemm")),
          f"the NLML gradient did not run through the kernels: {launches_nlml}")
    check(err <= GRAD_TOL * scale, f"NLML gradient on the card off the CPU's by {err} (scale {scale})")
    check(all(e <= t for e, t in zip(err64_i, tol64_i)),
          f"float64 NLML gradient on the card off the CPU's: {err64_i} > {tol64_i}")
    check(launches_logdet["trail"] > 0 and err_k <= GRAD_TOL * scale_k,
          f"log-det gradient on the card off the CPU's by {err_k} (scale {scale_k}), launches {launches_logdet}")
    check(all(raised.values()), f"an op without a backward did not raise under grad: {raised}")
    check(flash_launched == 1 and flash_grad["max_abs_err"] <= flash_grad["tol"],
          f"flash under grad: not the kernel forward with the plain version's gradient: {flash_grad}")


def phase_tf32(x_train, y_train, x_test, dev):
    """A GaussianProcess leaves the caller's TF32 flags as they were, and computes the same either way."""
    from repro_torch.core import GaussianProcess

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32)
    results, after = [], []
    try:
        for flags in ((True, True), (False, False)):
            matmul.allow_tf32, cudnn.allow_tf32 = flags
            gp = GaussianProcess(x_train[:4096], y_train[:4096], tile_size=TILE, device=dev)
            results.append(gp.predict_with_uncertainty(x_test[:1024]))
            after.append((matmul.allow_tf32, cudnn.allow_tf32))
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before
    same = all(torch.equal(a, b) for a, b in zip(*results))
    emit("tf32.scope", caller_flags=[[True, True], [False, False]], flags_after=after, results_bitwise_equal=same)
    check(after == [(True, True), (False, False)], f"GaussianProcess changed the caller's TF32 flags: {after}")
    check(same, "a GaussianProcess computed differently with the caller's TF32 flag on")


def dense_reference(x_train, y_train, x_test, dev, kernel=None, params=None):
    """(mean, variance) of a float64 dense solve on the card (a check, not a path of the port).

    SE at the paper's defaults unless a kernel and its params are given.
    """
    from repro_torch.core import kernels_math as km

    kernel = km.resolve_kernel(kernel)
    p = kernel.default_params() if params is None else params
    x64, xt64, y64 = (torch.as_tensor(a, device=dev).double() for a in (x_train, x_test, y_train))
    k64 = km.assemble_covariance(x64, p, kernel=kernel, dtype=None)
    l64 = torch.linalg.cholesky(k64)
    del k64
    alpha64 = torch.cholesky_solve(y64[:, None], l64)[:, 0]
    ks64 = km.assemble_cross_covariance(xt64, x64, p, kernel=kernel, dtype=None)
    mean_ref = ks64 @ alpha64
    v64 = torch.linalg.solve_triangular(l64, ks64.mT, upper=False)
    del ks64, l64
    var_ref = float(kernel.diag(km.concrete_params(p))) - (v64 * v64).sum(0)
    return mean_ref, var_ref


def accuracy_bounds(mean_ref, var_ref, mean_dense, var_dense):
    """The main phase's accuracy rule: errors and bounds against the float64 reference."""

    def e(a, b):
        return float((a.double() - b).abs().max())

    dense = {"mean_err_dense_f32": e(mean_dense, mean_ref), "var_err_dense_f32": e(var_dense, var_ref),
             "max_abs_mean_ref": float(mean_ref.abs().max()), "max_abs_var_ref": float(var_ref.abs().max())}
    mean_bound = 2 * dense["mean_err_dense_f32"] + 1e-4 * dense["max_abs_mean_ref"]
    var_bound = 2 * dense["var_err_dense_f32"] + 1e-4 * dense["max_abs_var_ref"]
    return e, dense, mean_bound, var_bound


BOUND_RULE = ("tiled f32 error <= 2 x dense f32 torch.linalg.cholesky error + 1e-4 max|ref|, "
              "both against a float64 dense solve on the card")


def phase_main(x_train, y_train, x_test, y_test, dev):
    """The gp_16k main path, cold and warm, with launch counts checked."""
    from repro_torch.core import GaussianProcess, executor
    from repro_torch.kernels import ops

    m_tiles = N_TRAIN // TILE
    q_tiles = N_TEST // TILE

    def expected(uncertainty):
        by_op = executor.program_plan(m_tiles, q_tiles, uncertainty, None).launches_by_op()
        return {
            **NO_LAUNCHES,
            "cov_tiles": sum(by_op.get(o, 0) for o in ("assemble", "cross", "prior")),
            "potrf": by_op.get("potrf", 0),
            "trsm": by_op.get("trsm", 0),
            "trail": by_op.get(executor.TRAIL, 0),
        }

    def delta(before, after):
        return {k: after[k] - before[k] for k in after}

    ops.reset_launch_counts()
    c0 = ops.launch_counts()
    gp = GaussianProcess(x_train, y_train, tile_size=TILE, device=dev)
    mean, t_cold = wall_s(lambda: gp.predict(x_test))
    c1 = ops.launch_counts()
    gp_u = GaussianProcess(x_train, y_train, tile_size=TILE, device=dev)
    (mean_u, var_u), t_cold_u = wall_s(lambda: gp_u.predict_with_uncertainty(x_test))
    c2 = ops.launch_counts()
    mean_w, t_warm = wall_s(lambda: gp_u.predict(x_test))
    c3 = ops.launch_counts()
    launches = delta(c0, c3)

    want = [expected(False), expected(True), {**NO_LAUNCHES, "cov_tiles": 1}]
    got = [delta(c0, c1), delta(c1, c2), delta(c2, c3)]
    emit("main.launches", calls=["predict (cold, fused)", "predict_with_uncertainty (cold, fused)",
                                 "predict (warm)"], launches=got, plan=want, total=launches)
    check(got == want, f"kernel launches {got} differ from the plan's {want}")
    check(all(launches[k] > 0 for k in MAIN_KERNELS), f"a kernel of the path never launched: {launches}")

    mean_ref, var_ref = dense_reference(x_train, y_train, x_test, dev)
    mono = GaussianProcess(x_train, y_train, pipeline="monolithic", device=dev)
    mean_d, t_mono = wall_s(lambda: mono.predict(x_test))
    (mean_du, var_d), t_mono_u = wall_s(lambda: mono.predict_with_uncertainty(x_test))
    e, dense, mean_bound, var_bound = accuracy_bounds(mean_ref, var_ref, mean_d, var_d)
    res = {
        "mean_err_tiled": e(mean, mean_ref),
        "mean_err_tiled_uncertainty_call": e(mean_u, mean_ref),
        "mean_err_warm": e(mean_w, mean_ref),
        "var_err_tiled": e(var_u, var_ref),
        **dense,
        "min_var_tiled": float(var_u.min()),
        "test_rmse_tiled": float(((mean.double() - torch.from_numpy(y_test).to(dev)) ** 2).mean().sqrt()),
    }
    finite = all(bool(torch.isfinite(t).all()) for t in (mean, mean_u, var_u, mean_w))
    shapes = [tuple(t.shape) for t in (mean, mean_u, var_u, mean_w)]
    emit("main.correctness", **res, mean_bound=mean_bound, var_bound=var_bound, finite=finite,
         shapes=shapes, bound_rule=BOUND_RULE)
    check(finite and shapes == [(N_TEST,)] * 4, f"non-finite or misshapen outputs: {shapes}")
    for name in ("mean_err_tiled", "mean_err_tiled_uncertainty_call", "mean_err_warm"):
        check(res[name] <= mean_bound, f"{name} {res[name]} above {mean_bound}")
    check(res["var_err_tiled"] <= var_bound, f"variance error {res['var_err_tiled']} above {var_bound}")
    emit("main.times", seconds={"tiled_cold_predict": t_cold, "tiled_cold_predict_with_uncertainty": t_cold_u,
                                "tiled_warm_predict": t_warm, "dense_predict": t_mono,
                                "dense_predict_with_uncertainty": t_mono_u},
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def carry_phase(x_win, y_win, dev):
    """The carry kernel at the eviction's first UCARRY launch (G = 31, m = 512).

    The operands are those of a real eviction: the 33-tile factor of the
    window plus one appended tile, its leading tile-column dropped as
    ``update.shrink_state`` drops it, and the sweep's first two levels
    (UPREP of column 0, UPROW of its panel) run with the executor's own ops.
    """
    from repro_torch.core import executor, kernels_math as km, predict as pred
    from repro_torch.core import scheduler as sch, tiling
    from repro_torch.kernels import carry_update, ops, potrf_tile

    m = TILE
    n = N_TRAIN + TILE
    state = pred.posterior_state(x_win[:n], y_win[:n], km.SEKernelParams.paper_defaults(), m, device=dev)
    m_tiles = n // m
    trailing, evicted = (torch.from_numpy(a).to(dev) for a in tiling.shrink_packed_indices(m_tiles))
    lp, w = state.lpacked[trailing], state.lpacked[evicted]
    del state
    plan = executor.update_rank_plan(m_tiles - 1)
    (prep,), (prow,), (carry,) = plan.levels[:3]
    check((prep.op, prow.op, carry.op) == (sch.UPREP, sch.UPROW, sch.UCARRY),
          f"unexpected first levels of the rank plan: {prep.op}, {prow.op}, {carry.op}")
    uprep, uprow, _ = executor.get_update_ops(1.0)

    def ix(a):
        return torch.from_numpy(a).to(dev)

    _, x, y, c = uprep(lp[ix(prep.a)], w[ix(prep.out)])
    g = carry.size
    lrow = uprow(lp[ix(prow.a)], w[ix(prow.b)], x.expand(g, m, m), y.expand(g, m, m))
    check(bool((ix(prow.out) == ix(carry.a)).all()), "UPROW and UCARRY tiles differ in order")
    wc, lc = w[ix(carry.b)].contiguous(), lrow.contiguous()
    yc, cc = y.expand(g, m, m).contiguous(), c.expand(g, m, m).contiguous()
    del lp, w

    out = ops.carry_update(wc, lc, yc, cc)
    torch.cuda.synchronize()
    ref = carry_update.carry_update_plain(wc, lc, yc, cc)
    scale = max(1.0, float(ref.abs().max()))
    err = max_err(out, ref)
    tol = 1e-3 * scale
    d64 = [t.double() for t in (wc, lc, yc, cc)]
    ref64 = carry_update.carry_update_plain(*d64)
    err64 = max_err(ops.carry_update(*d64), ref64)
    tol64 = 1e-9 * max(1.0, float(ref64.abs().max()))
    cdiag = torch.diagonal(c[0])
    # random well-conditioned cases at ragged m (masked edges), both types
    gen = torch.Generator().manual_seed(SEED)
    edge = {}
    for dt, mm, g_e, tol_e in ((torch.float32, 100, 5, 1e-3), (torch.float32, 77, 3, 1e-3),
                               (torch.float64, 100, 5, 1e-10), (torch.float64, 77, 3, 1e-10)):
        ws, ls, ys, rs = (torch.randn(g_e, mm, mm, generator=gen, dtype=dt) / mm**0.5 for _ in range(4))
        cs = potrf_tile.potrf_plain(torch.eye(mm, dtype=dt) + rs @ rs.mT)
        ws, ls, ys, cs = (t.to(dev) for t in (ws, ls, ys, cs))
        key = f"{str(dt).split('.')[-1]}_m{mm}"
        edge[key] = max_err(ops.carry_update(ws, ls, ys, cs), carry_update.carry_update_plain(ws, ls, ys, cs))
        check(edge[key] <= tol_e, f"carry_update {key}: kernel disagrees with its plain version: {edge[key]}")
    # a tile past the 32-row (float32) and 16-row (float64) strip: m = 2048 takes a shorter one
    from repro_torch.kernels import _build

    lib = _build.load("carry_update")
    big = {"strip_rows_float32": lib.carry_update_f32_strip(CARRY_BIG_M),
           "max_m": {"float32": lib.carry_update_max_m(0), "float64": lib.carry_update_max_m(1)}}
    for dt, tol_e in ((torch.float32, 1e-3), (torch.float64, 1e-10)):
        ws, ls, ys, rs = (torch.randn(2, CARRY_BIG_M, CARRY_BIG_M, generator=gen, dtype=dt).to(dev) / CARRY_BIG_M**0.5
                          for _ in range(4))
        cs = torch.linalg.cholesky(torch.eye(CARRY_BIG_M, dtype=dt, device=dev) + rs @ rs.mT).contiguous()
        key = f"{str(dt).split('.')[-1]}_m{CARRY_BIG_M}"
        edge[key] = max_err(ops.carry_update(ws, ls, ys, cs), carry_update.carry_update_plain(ws, ls, ys, cs))
        big[f"{key}_ms"] = cuda_ms(lambda: ops.carry_update(ws, ls, ys, cs), 3)
        check(edge[key] <= tol_e, f"carry_update {key}: kernel disagrees with its plain version: {edge[key]}")
        del ws, ls, ys, rs, cs
    nbytes = 5 * wc.numel() * 4
    bnd = bound_ms(nbytes, 3 * g * m**3)
    row = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/carry_update.cu",
        replaces="src/repro/kernels/downdate_tile.py:29", max_abs_err=max(err, err64, *edge.values()),
        ms=cuda_ms(lambda: ops.carry_update(wc, lc, yc, cc), 10),
        plain_ms=cuda_ms(lambda: carry_update.carry_update_plain(wc, lc, yc, cc), 2),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(
            lambda: torch.linalg.solve_triangular(cc.mT, wc - torch.bmm(lc, yc), upper=True, left=False), 10
        ),
    )
    emit("kernel.carry_update", shape=list(wc.shape), max_abs_err=err, tol=tol, f64_max_abs_err=err64,
         f64_tol=tol64, edge_errors=edge, edge_tol="1e-3 (float32), 1e-10 (float64)",
         max_abs_plain=scale, c_diag_min=float(cdiag.min()), c_diag_max=float(cdiag.max()),
         tol_reason="float32: 1e-3 max(1, max|plain|), the trsm tolerance scaled to the carry's size; "
         "the product (K = 512) and the solve sum in another order; float64 on the same operands: "
         "1e-9 max(1, max|plain|)",
         library_call="two calls: torch.bmm, then torch.linalg.solve_triangular(C^T, left=False)",
         f64_ms=cuda_ms(lambda: ops.carry_update(*d64), 5), big_tile=big,
         **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    check(err <= tol, f"carry_update disagrees with its plain version: {err} > {tol}")
    check(err64 <= tol64, f"carry_update (float64) disagrees with its plain version: {err64} > {tol64}")
    ctas_per_sm = lib.carry_update_f32_ctas_per_sm(m)
    strip_rows = lib.carry_update_f32_strip(m)
    ptxas, mma = ptxas_report("carry_update", carry_label), sass_mma_counts("carry_update", carry_label)
    emit("kernel.carry_update.extra", shape=list(wc.shape), tflops=3 * g * m**3 / row["ms"] / 1e9,
         library_tflops=3 * g * m**3 / row["library_ms"] / 1e9, strip_rows=strip_rows, ctas_per_sm=ctas_per_sm,
         ptxas=ptxas, sass_hmma_count=mma)
    check(ctas_per_sm >= 2 and strip_rows == 32,
          f"carry_update: {ctas_per_sm} CTAs per SM on a {strip_rows}-row strip at m = 512, not two on 32")
    check_build_quality("carry_update", ptxas, mma)
    torch.cuda.synchronize()
    return row


def update_launches_per_step():
    """Kernel launches of one step at gp_16k: append one tile-row to M tiles, evict one tile."""
    from repro_torch.core import executor

    m_tiles = N_TRAIN // TILE
    ap = executor.update_append_plan(m_tiles, m_tiles).launches_by_op()
    rp = executor.update_rank_plan(m_tiles).launches_by_op()
    return {
        **NO_LAUNCHES,
        "cov_tiles": ap["uasm"] + ap["uasmd"],
        "potrf": ap["upotrf"] + 2 * rp["uprep"],  # UPREP factors two tiles
        "trsm": ap["utrsm"],
        "trail": ap["ugemm"] + ap["usyrk"],
        "carry_update": rp["ucarry"],
    }


def phase_update(x_win, y_win, x_test, dev):
    """The sliding-window path at gp_16k width, with launches and accuracy checked."""
    from repro_torch.core import GaussianProcess, update
    from repro_torch.kernels import ops

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    per_step = update_launches_per_step()
    check(per_step["carry_update"] == 31 and per_step["potrf"] == 65,
          f"unexpected update plans at gp_16k: {per_step}")
    gp = GaussianProcess(x_win[:N_TRAIN], y_win[:N_TRAIN], tile_size=TILE, sliding_window=N_TRAIN,
                         device=dev)
    _, t_cold = wall_s(lambda: gp.predict(x_test))
    total = dict(NO_LAUNCHES)
    steps = []
    for step in range(1, UPDATE_STEPS + 1):
        lo, hi = step * TILE, N_TRAIN + step * TILE
        # the path: the step, then warm predictions, each with its counts set to 0 before
        (_, t_update), c_update = counted(lambda: wall_s(lambda: gp.update(x_win[hi - TILE:hi],
                                                                          y_win[hi - TILE:hi])))
        warm = gp._cache_warm()
        (mean, t_warm), c_warm = counted(lambda: wall_s(lambda: gp.predict(x_test)))
        ((mean_u, var_u), t_warm_u), c_warm_u = counted(
            lambda: wall_s(lambda: gp.predict_with_uncertainty(x_test)))
        for c in (c_update, c_warm, c_warm_u):
            total = {k: total[k] + c[k] for k in total}
        # the kept window against a float64 dense solve and the dense float32 pipeline
        mean_ref, var_ref = dense_reference(x_win[lo:hi], y_win[lo:hi], x_test, dev)
        mono = GaussianProcess(x_win[lo:hi], y_win[lo:hi], pipeline="monolithic", device=dev)
        mean_d, var_d = mono.predict_with_uncertainty(x_test)
        e, dense, mean_bound, var_bound = accuracy_bounds(mean_ref, var_ref, mean_d, var_d)
        res = dict(step=step, window=[lo, hi], n=int(gp.y_train.shape[0]), cache_warm=warm,
                   launches_update=c_update, plan=per_step, launches_warm_predict=c_warm,
                   launches_warm_predict_with_uncertainty=c_warm_u,
                   seconds={"update": t_update, "warm_predict": t_warm,
                            "warm_predict_with_uncertainty": t_warm_u},
                   mean_err=e(mean, mean_ref), mean_err_uncertainty_call=e(mean_u, mean_ref),
                   var_err=e(var_u, var_ref), **dense, mean_bound=mean_bound, var_bound=var_bound,
                   finite=all(bool(torch.isfinite(t).all()) for t in (mean, mean_u, var_u)),
                   shapes=[tuple(t.shape) for t in (mean, mean_u, var_u)])
        steps.append(res)
        emit("update.step", **res, bound_rule=BOUND_RULE)
        check(warm and res["n"] == N_TRAIN, f"step {step}: cache cold or window {res['n']} != {N_TRAIN}")
        check(c_update == per_step, f"step {step}: launches {c_update} differ from the plans' {per_step}")
        check(c_warm == {**NO_LAUNCHES, "cov_tiles": 1}, f"step {step}: warm predict launched {c_warm}")
        check(c_warm_u == {**NO_LAUNCHES, "cov_tiles": 2},
              f"step {step}: warm predict_with_uncertainty launched {c_warm_u}")
        check(res["finite"] and res["shapes"] == [(N_TEST,)] * 3, f"step {step}: outputs {res['shapes']}")
        for name in ("mean_err", "mean_err_uncertainty_call"):
            check(res[name] <= mean_bound, f"step {step}: {name} {res[name]} above {mean_bound}")
        check(res["var_err"] <= var_bound, f"step {step}: variance error {res['var_err']} above {var_bound}")
    check(all(total[k] > 0 for k in UPDATE_KERNELS), f"a kernel of the update path never launched: {total}")

    # a non-PD downdate must surface as NaN from the POTRF kernel, then raise
    rng = np.random.default_rng(SEED)
    n_small, m_small = 48, 16
    a = rng.standard_normal((n_small, n_small))
    lfac = torch.linalg.cholesky(torch.from_numpy(a @ a.T + n_small * np.eye(n_small)).float())
    from repro_torch.core import tiling

    lp = tiling.pack_lower(lfac, m_small).to(dev)
    w = torch.from_numpy(rng.standard_normal((n_small // m_small, m_small, m_small)) * 100.0).float().to(dev)
    ops.reset_launch_counts()
    try:
        update.downdate_factor(lp, w, device=dev)
        raised = False
    except update.CholeskyUpdateError:
        raised = True
    nonpd = ops.launch_counts()
    emit("update.nonpd_downdate", raised=raised, launches=nonpd)
    check(raised and nonpd["potrf"] > 0, f"a non-PD downdate did not raise on the card: {nonpd}")
    emit("update", steps=UPDATE_STEPS, cold_predict_seconds=t_cold, launches=total)
    return total


def phase_update_timing(x_win, y_win, x_test, dev):
    """One sliding-window step beside a cold refactorization of the same window, in turns.

    A step is ``PosteriorState.extend`` (append one tile-row) then
    ``shrink`` (evict the oldest tile) of the window's cached state, timed
    apart; it leaves the cached state as it was, so every turn does the
    same work.  ``cold`` is a tiled ``predict`` on a new GP of the window
    after the step, ``dense`` the ``torch.linalg.cholesky`` pipeline on it.
    """
    from repro_torch.core import GaussianProcess, predict as pred

    base = GaussianProcess(x_win[:N_TRAIN], y_win[:N_TRAIN], tile_size=TILE, device=dev)
    base.predict(x_test)
    state = base._posterior
    new = slice(N_TRAIN, N_TRAIN + TILE)
    kept = slice(TILE, N_TRAIN + TILE)
    times = {"append": [], "evict": [], "warm_predict": [], "tiled_cold": [], "dense": []}
    for order in ("step", "cold", "dense", "dense", "cold", "step"):
        if order == "step":
            grown, t_a = wall_s(lambda: state.extend(x_win[new], y_win[new]))
            kept_state, t_e = wall_s(lambda: grown.shrink(TILE))
            del grown
            times["append"].append(t_a)
            times["evict"].append(t_e)
            times["warm_predict"].append(wall_s(lambda: pred.predict_from_state(kept_state, x_test))[1])
            del kept_state
        elif order == "cold":
            gp = GaussianProcess(x_win[kept], y_win[kept], tile_size=TILE, device=dev)
            times["tiled_cold"].append(wall_s(lambda: gp.predict(x_test))[1])
        else:
            mono = GaussianProcess(x_win[kept], y_win[kept], pipeline="monolithic", device=dev)
            times["dense"].append(wall_s(lambda: mono.predict(x_test))[1])
    emit("timing.update", seconds=times, order="step, cold, dense, dense, cold, step",
         note="host clock around calls ending in torch.cuda.synchronize(); "
         "a step is append (extend) + evict (shrink) of the cached window state")


PORT_KERNEL_PREFIX = "void (anonymous namespace)::"


def profile_call(phase: str, call: str, fn):
    """Device time by kernel, and the device's idle share, over one call of ``fn``.

    ``torch.profiler`` traces the card through CUPTI; the run is one stream,
    so the sum of device times is the busy time.  Profiling slows the host,
    so ``wall_ms`` here is above the unprofiled times of phase ``timing``.
    Returns the rows (name, count, device ms), the busy ms and the wall ms.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = wall_s(fn)
    # device-side events only: a CPU op's self device time repeats its kernels'
    rows = sorted(
        ((e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[2],
    )
    busy_ms = sum(r[2] for r in rows)
    # every kernel of the port, by name and type (``carry_prep<float>``), however small
    port = {}
    for k, c, ms in rows:
        if k.startswith(PORT_KERNEL_PREFIX) and "at::native" not in k:
            name = k[len(PORT_KERNEL_PREFIX):].split("(")[0]
            count, total = port.get(name, (0, 0.0))
            port[name] = (count + c, total + ms)
    emit(phase, call=call, wall_ms=wall * 1e3,
         device_busy_ms=busy_ms if rows else "not measured",
         device_idle_share=1.0 - busy_ms / (wall * 1e3) if rows else "not measured",
         top=[{"name": k[:100], "count": c, "device_ms": ms} for k, c, ms in rows[:14]],
         port_kernels={k: {"count": c, "device_ms": ms} for k, (c, ms) in port.items()})
    return rows, busy_ms, wall * 1e3


def phase_profile(x_train, y_train, x_test, x_win, y_win, dev):
    """One cold predict, and one sliding-window step (update + warm predict)."""
    from repro_torch.core import GaussianProcess

    gp = GaussianProcess(x_train, y_train, tile_size=TILE, device=dev)
    profile_call("profile", "predict (cold, fused), gp_16k", lambda: gp.predict(x_test))
    win = GaussianProcess(x_win[:N_TRAIN], y_win[:N_TRAIN], tile_size=TILE,
                          sliding_window=N_TRAIN, device=dev)
    win.predict(x_test)
    new = slice(N_TRAIN, N_TRAIN + TILE)

    def step():
        win.update(x_win[new], y_win[new])
        return win.predict(x_test)

    profile_call("profile.update", "update(512) + predict (warm), gp_16k sliding window", step)
    check(win._cache_warm(), "the profiled sliding-window step fell back to a refactorization")


def phase_timing(x_train, y_train, x_test, dev):
    """Repeated cold/warm tiled predictions beside the dense baseline, in turns."""
    from repro_torch.core import GaussianProcess

    times = {"tiled_cold": [], "tiled_warm": [], "dense": []}
    for order in ("tiled", "dense", "dense", "tiled"):
        if order == "tiled":
            gp = GaussianProcess(x_train, y_train, tile_size=TILE, device=dev)
            times["tiled_cold"].append(wall_s(lambda: gp.predict(x_test))[1])
            times["tiled_warm"].append(wall_s(lambda: gp.predict(x_test))[1])
        else:
            mono = GaussianProcess(x_train, y_train, pipeline="monolithic", device=dev)
            times["dense"].append(wall_s(lambda: mono.predict(x_test))[1])
    emit("timing", seconds=times, order="tiled, dense, dense, tiled",
         note="host clock around calls ending in torch.cuda.synchronize()")


def lrgemm_phase(x_lr, y_lr, dev):
    """The LRGEMM kernel at the cold build's launch: G = 2048 tiles of K_un (m = mb = 512)."""
    from repro_torch.core import executor, kernels_math as km, lowrank, predict as pred, tiling
    from repro_torch.kernels import lrgemm_tile, ops

    m, n = TILE, LR_N_TRAIN
    params = km.SEKernelParams.paper_defaults()
    x = torch.from_numpy(x_lr).to(dev)
    u, _ = lowrank.select_inducing(x, LR_M_INDUCING)
    uc, xc = tiling.pad_features(u, m), tiling.pad_features(x, m)
    kun = pred.assemble_cross_tiles(uc, xc, params, LR_M_INDUCING, n)  # (4, 512, 512, 512)
    mu_tiles, n_tiles = kun.shape[:2]
    kflat = kun.reshape(mu_tiles * n_tiles, m, m)
    yc = tiling.pad_vector(torch.from_numpy(y_lr).to(dev), m)
    (bt,), = executor.lowrank_plan(mu_tiles, n_tiles).levels
    a, b = (torch.from_numpy(i).to(dev) for i in (bt.a, bt.b))
    g = a.shape[0]

    def kern():
        return ops.lrgemm(kflat, yc, a, b)

    def plain():
        return lrgemm_tile.lrgemm_plain(kflat, yc, a, b)

    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    scale = max(1.0, float(ref.abs().max()))
    err, tol = max_err(out, ref), 1e-4 * scale
    k64, y64 = kflat.double(), yc.double()
    ref64 = lrgemm_tile.lrgemm_plain(k64, y64, a, b)
    err64 = max_err(ops.lrgemm(k64, y64, a, b), ref64)
    tol64 = 1e-12 * max(1.0, float(ref64.abs().max()))
    f64_ms = cuda_ms(lambda: ops.lrgemm(k64, y64, a, b), 5)
    del k64, y64, ref64
    # odd G, mb != m (vector path), and an odd mb (the scalar path), both types
    gen = torch.Generator().manual_seed(SEED)
    edge = {}
    for dt, g_e, m_e, mb_e, tol_e in ((torch.float32, 7, 512, 384, 1e-4), (torch.float32, 5, 100, 45, 1e-4),
                                       (torch.float64, 7, 512, 384, 1e-12), (torch.float64, 5, 100, 45, 1e-12)):
        ks = torch.randn(g_e + 2, m_e, mb_e, generator=gen, dtype=dt).to(dev)
        vs = torch.randn(3, mb_e, generator=gen, dtype=dt).to(dev)
        ai = torch.randperm(g_e + 2, generator=gen)[:g_e].to(dev)
        bi = torch.randint(0, 3, (g_e,), generator=gen).to(dev)
        want = lrgemm_tile.lrgemm_plain(ks, vs, ai, bi)
        key = f"{str(dt).split('.')[-1]}_G{g_e}_m{m_e}_mb{mb_e}"
        edge[key] = max_err(ops.lrgemm(ks, vs, ai, bi), want)
        check(edge[key] <= tol_e * max(1.0, float(want.abs().max())),
              f"lrgemm {key}: kernel disagrees with its plain version: {edge[key]}")
    vstack = yc.index_select(0, b)[:, :, None]  # one gathered chunk per tile, for torch.bmm
    nbytes = (kflat.numel() + yc.numel() + out.numel()) * 4 + 2 * g * 8
    bnd = bound_ms(nbytes, 2 * g * m * m)
    row = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lrgemm_tile.cu",
        replaces="src/repro/kernels/lrgemm_tile.py:18", max_abs_err=max(err, err64, *edge.values()),
        ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 3), bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(lambda: torch.bmm(kflat, vstack), 20),
    )
    emit("kernel.lrgemm", shape=[g, m, m], max_abs_err=err, tol=tol, f64_max_abs_err=err64, f64_tol=tol64,
         edge_errors=edge, edge_tol="1e-4 (float32), 1e-12 (float64), times max(1, max|plain|)",
         max_abs_plain=scale, f64_ms=f64_ms, achieved_tb_per_s=nbytes / row["ms"] / 1e9,
         library_tb_per_s=nbytes / row["library_ms"] / 1e9, kernel_over_library=row["ms"] / row["library_ms"],
         tol_reason="float32: sums of 512 products in another order, 1e-4 max(1, max|plain|); "
         "float64 on the same operands: 1e-12 max(1, max|plain|)",
         library_call="torch.bmm(K_un tiles, gathered y chunks) (cuBLAS), the gather not timed",
         **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    check(err <= tol, f"lrgemm disagrees with its plain version: {err} > {tol}")
    check(err64 <= tol64, f"lrgemm (float64) disagrees with its plain version: {err64} > {tol64}")
    del kun, kflat, out, ref, vstack
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


def dense_dtc(x, y, x_test, u, dtype, dev, *, with_var=True, jax_formulas=False):
    """(mean, variance) of the dense DTC in whitened (SGPR) form, plain torch on the card.

    K_uu is retuned as the tiled build retunes it: the diagonal pinned to
    v + sigma^2, then shifted by jitter - sigma^2, each rounded to ``dtype``.
    The mean is sigma^-2 (L_B^-1 L_uu^-1 K_u*)^T L_B^-1 W y; with
    ``jax_formulas`` it is the JAX package's sigma^-2 K_*u gamma, gamma =
    L_uu^-T B^-1 L_uu^-1 c from c = K_un y.  A check and a yardstick, not a
    path of the port.
    """
    from repro_torch.core import kernels_math as km
    from repro_torch.core.lowrank import DEFAULT_JITTER

    def solve(l, b, upper=False):
        return torch.linalg.solve_triangular(l, b, upper=upper)

    p = km.SEKernelParams.paper_defaults()
    x, y, xt, u = (torch.as_tensor(a, device=dev).to(dtype) for a in (x, y, x_test, u))
    kuu = km.assemble_covariance(u, p, dtype=None)
    kuu.diagonal().add_(torch.tensor(DEFAULT_JITTER, dtype=dtype, device=dev) - p.noise)
    luu = torch.linalg.cholesky(kuu)
    kun = km.assemble_cross_covariance(u, x, p, dtype=None)
    c = kun @ y[:, None]
    w = solve(luu, kun)
    del kun
    lb = torch.linalg.cholesky(torch.eye(u.shape[0], dtype=dtype, device=dev) + (w @ w.mT) / p.noise)
    wy = w @ y[:, None]
    del w
    kus = km.assemble_cross_covariance(u, xt, p, dtype=None)
    v1 = solve(luu, kus)
    v2 = solve(lb, v1)
    if jax_formulas:
        gamma = solve(luu.mT, solve(lb.mT, solve(lb, solve(luu, c)), upper=True), upper=True)
        mean = (kus.mT @ gamma)[:, 0] / p.noise
    else:
        mean = (v2.mT @ solve(lb, wy))[:, 0] / p.noise
    if not with_var:
        return mean
    return mean, p.vertical - (v1 * v1).sum(0) + (v2 * v2).sum(0)


def lowrank_launches(m_inducing=LR_M_INDUCING):
    """Kernel launches of the low-rank path's pieces, from the plans (gp_256k_lowrank: MU = 4 inducing tiles)."""
    from repro_torch.core import executor

    mu_tiles = m_inducing // TILE
    chol = executor.cholesky_plan(mu_tiles).launches_by_op()
    one_chol = {"potrf": chol["potrf"], "trsm": chol.get("trsm", 0),
                "trail": chol.get("syrk", 0) + chol.get("gemm", 0)}

    def pieces(cov, lrgemm, chols):
        scaled = {k: chols * v for k, v in one_chol.items()}
        return {**NO_LAUNCHES, "cov_tiles": cov, "lrgemm": lrgemm, **scaled}

    # cold build: K_uu + K_un, c = K_un y and c_w = W y, chol(K_uu) + chol(B);
    # the head adds CROSS (+ PRIOR); a step (update(512)) is two absorbs, the
    # new rows in and the 512 oldest out, each K_ub, dc and dc_w, chol(B)
    return {
        "cold_predict": pieces(3, 2, 2),
        "cold_predict_with_uncertainty": pieces(4, 2, 2),
        "warm_predict": pieces(1, 0, 0),
        "warm_predict_with_uncertainty": pieces(2, 0, 0),
        "step": pieces(2, 4, 2),
    }


def lowrank_accuracy(tiled, x, y, x_test, u, dev):
    """Errors of tiled (mean, var) against the float64 dense DTC, and the bounds of the rule.

    Reference and float32 comparator are the dense DTC in SGPR form.  The
    float32 mean error of the JAX package's formulas (gamma solved from
    c = K_un y) is reported beside them.
    """
    mean_ref, var_ref = dense_dtc(x, y, x_test, u, torch.float64, dev)
    mean_d, var_d = dense_dtc(x, y, x_test, u, torch.float32, dev)
    e, dense, mean_bound, var_bound = accuracy_bounds(mean_ref, var_ref, mean_d, var_d)
    mean_j = dense_dtc(x, y, x_test, u, torch.float32, dev, with_var=False, jax_formulas=True)
    dense["mean_err_dense_f32_jax_formulas"] = e(mean_j, mean_ref)
    errs = {name: e(t, mean_ref if name.startswith("mean") else var_ref) for name, t in tiled.items()}
    return errs, dense, mean_bound, var_bound


def phase_lowrank(x_lr, y_lr, x_lt, x_lw, y_lw, dev):
    """The gp_256k_lowrank path, cold, warm and two sliding-window steps, launches and accuracy checked."""
    from repro_torch.core import GaussianProcess, lowrank
    from repro_torch.kernels import ops

    plan = lowrank_launches()
    kw = dict(tile_size=TILE, method="lowrank", m_inducing=LR_M_INDUCING, device=dev)

    def counted(fn):
        ops.reset_launch_counts()
        out, t = wall_s(fn)
        return out, t, ops.launch_counts()

    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gp = GaussianProcess(x_lr, y_lr, **kw)
    mean, t_cold, c_cold = counted(lambda: gp.predict(x_lt))
    peak_cold = torch.cuda.max_memory_allocated() - base_mem
    del gp
    torch.cuda.reset_peak_memory_stats()
    gp_u = GaussianProcess(x_lr, y_lr, **kw)
    (mean_u, var_u), t_cold_u, c_cold_u = counted(lambda: gp_u.predict_with_uncertainty(x_lt))
    peak_cold_u = torch.cuda.max_memory_allocated() - base_mem
    mean_w, t_warm, c_warm = counted(lambda: gp_u.predict(x_lt))
    total = {k: c_cold[k] + c_cold_u[k] + c_warm[k] for k in NO_LAUNCHES}
    got = [c_cold, c_cold_u, c_warm]
    want = [plan["cold_predict"], plan["cold_predict_with_uncertainty"], plan["warm_predict"]]
    emit("lowrank.launches", calls=["predict (cold)", "predict_with_uncertainty (cold)", "predict (warm)"],
         launches=got, plan=want)
    check(got == want, f"low-rank launches {got} differ from the plans' {want}")

    u = lowrank.select_inducing(torch.from_numpy(x_lr).to(dev), LR_M_INDUCING)[0]
    errs, dense, mean_bound, var_bound = lowrank_accuracy(
        {"mean_err_tiled": mean, "mean_err_tiled_uncertainty_call": mean_u, "mean_err_warm": mean_w,
         "var_err_tiled": var_u}, x_lr, y_lr, x_lt, u, dev)
    finite = all(bool(torch.isfinite(t).all()) for t in (mean, mean_u, var_u, mean_w))
    shapes = [tuple(t.shape) for t in (mean, mean_u, var_u, mean_w)]
    emit("lowrank.correctness", **errs, **dense, mean_bound=mean_bound, var_bound=var_bound, finite=finite,
         shapes=shapes, min_var_tiled=float(var_u.min()),
         bound_rule=BOUND_RULE.replace("a float64 dense solve", "a float64 dense DTC (whitened, same K_uu)"))
    check(finite and shapes == [(LR_N_TEST,)] * 4, f"low-rank: non-finite or misshapen outputs {shapes}")
    for name in ("mean_err_tiled", "mean_err_tiled_uncertainty_call", "mean_err_warm"):
        check(errs[name] <= mean_bound, f"low-rank {name} {errs[name]} above {mean_bound}")
    check(errs["var_err_tiled"] <= var_bound, f"low-rank variance error {errs['var_err_tiled']} above {var_bound}")
    del gp_u, mean, mean_u, var_u, mean_w

    # two sliding-window steps on a pinned inducing set (the window's subset)
    n = LR_N_TRAIN
    u_pin = lowrank.select_inducing(torch.from_numpy(x_lw[:n]).to(dev), LR_M_INDUCING)[0]
    win = GaussianProcess(x_lw[:n], y_lw[:n], sliding_window=n, inducing=u_pin, **kw)
    win.predict(x_lt)
    for step in range(1, LR_STEPS + 1):
        lo, hi = step * TILE, n + step * TILE
        _, t_step, c_step = counted(lambda: win.update(x_lw[hi - TILE:hi], y_lw[hi - TILE:hi]))
        warm = win._lowrank_warm()
        mean, t_warm, c_w = counted(lambda: win.predict(x_lt))
        (mean_u, var_u), t_warm_u, c_wu = counted(lambda: win.predict_with_uncertainty(x_lt))
        for c in (c_step, c_w, c_wu):
            total = {k: total[k] + c[k] for k in total}
        errs, dense, mean_bound, var_bound = lowrank_accuracy(
            {"mean_err": mean, "mean_err_uncertainty_call": mean_u, "var_err": var_u},
            x_lw[lo:hi], y_lw[lo:hi], x_lt, u_pin, dev)
        res = dict(step=step, window=[lo, hi], n=int(win.y_train.shape[0]), state_n=win._lowrank.n,
                   cache_warm=warm, launches_step=c_step, plan=plan["step"], launches_warm_predict=c_w,
                   launches_warm_predict_with_uncertainty=c_wu,
                   seconds={"step": t_step, "warm_predict": t_warm, "warm_predict_with_uncertainty": t_warm_u},
                   **errs, **dense, mean_bound=mean_bound, var_bound=var_bound,
                   finite=all(bool(torch.isfinite(t).all()) for t in (mean, mean_u, var_u)))
        emit("lowrank.step", **res)
        check(warm and res["n"] == res["state_n"] == n, f"low-rank step {step}: cache cold or window {res['n']}")
        check(c_step == plan["step"], f"low-rank step {step}: launches {c_step} differ from {plan['step']}")
        check(c_w == plan["warm_predict"] and c_wu == plan["warm_predict_with_uncertainty"],
              f"low-rank step {step}: warm predictions launched {c_w}, {c_wu}")
        check(res["finite"], f"low-rank step {step}: non-finite outputs")
        for name in ("mean_err", "mean_err_uncertainty_call"):
            check(errs[name] <= mean_bound, f"low-rank step {step}: {name} {errs[name]} above {mean_bound}")
        check(errs["var_err"] <= var_bound, f"low-rank step {step}: variance error {errs['var_err']} above {var_bound}")
    check(all(total[k] > 0 for k in LOWRANK_KERNELS), f"a kernel of the low-rank path never launched: {total}")
    emit("lowrank", launches=total, cold_predict_seconds=t_cold, cold_predict_with_uncertainty_seconds=t_cold_u,
         peak_memory_gib={"cold_predict": peak_cold / 2**30, "cold_predict_with_uncertainty": peak_cold_u / 2**30},
         memory_before_gib=base_mem / 2**30)
    del win
    torch.cuda.empty_cache()
    return total


def phase_lowrank_timing(x_lr, y_lr, x_lt, y_lt, x_lw, y_lw, data16, dev):
    """Cold and warm low-rank calls, a step against a cold rebuild, and the two tiers at gp_16k; in turns."""
    from repro_torch.core import GaussianProcess, lowrank

    kw = dict(tile_size=TILE, method="lowrank", m_inducing=LR_M_INDUCING, device=dev)
    u = lowrank.select_inducing(torch.from_numpy(x_lr).to(dev), LR_M_INDUCING)[0]
    times = {"lowrank_cold": [], "lowrank_warm": [], "dense_dtc_f32": []}
    for order in ("tiled", "dense", "dense", "tiled"):
        if order == "tiled":
            gp = GaussianProcess(x_lr, y_lr, **kw)
            mean, t = wall_s(lambda: gp.predict(x_lt))
            times["lowrank_cold"].append(t)
            times["lowrank_warm"].append(wall_s(lambda: gp.predict(x_lt))[1])
            del gp
        else:
            times["dense_dtc_f32"].append(
                wall_s(lambda: dense_dtc(x_lr, y_lr, x_lt, u, torch.float32, dev, with_var=False))[1])
    rmse = float(((mean.double() - torch.from_numpy(y_lt).to(dev)) ** 2).mean().sqrt())

    # one sliding-window step on the cached state (absorb 512, forget the 512 oldest) beside a cold rebuild
    n = LR_N_TRAIN
    u_pin = lowrank.select_inducing(torch.from_numpy(x_lw[:n]).to(dev), LR_M_INDUCING)[0]
    base = GaussianProcess(x_lw[:n], y_lw[:n], inducing=u_pin, **kw)
    base.predict(x_lt)
    state = base.lowrank_posterior()
    new, old = slice(n, n + TILE), slice(0, TILE)
    steps = {"absorb": [], "forget": [], "warm_predict": [], "cold_rebuild": []}
    for order in ("step", "cold", "cold", "step"):
        if order == "step":
            grown, t_a = wall_s(lambda: lowrank.absorb(state, x_lw[new], y_lw[new]))
            kept, t_f = wall_s(lambda: lowrank.absorb(grown, x_lw[old], y_lw[old], sign=-1))
            steps["absorb"].append(t_a)
            steps["forget"].append(t_f)
            steps["warm_predict"].append(wall_s(lambda: lowrank.predict_from_lowrank_state(kept, x_lt))[1])
        else:
            gp = GaussianProcess(x_lw[TILE:n + TILE], y_lw[TILE:n + TILE], inducing=u_pin, **kw)
            steps["cold_rebuild"].append(wall_s(lambda: gp.predict(x_lt))[1])
            del gp
    del base, state, grown, kept
    emit("timing.lowrank", seconds={**times, **steps}, test_rmse_lowrank=rmse,
         order="cold: tiled, dense, dense, tiled; step: step, cold, cold, step",
         note="host clock around calls ending in torch.cuda.synchronize(); dense_dtc_f32 is the whitened "
         "dense DTC mean in plain torch (cuBLAS, cuSOLVER); a step is absorb(512) + absorb(-512) of the "
         "window's cached state; cold_rebuild is a new GP's cold predict on the kept window")

    # gp_16k: the low-rank tier (m_inducing 2048) beside the exact tiled tier
    x_tr, y_tr, x_te, y_te = data16
    y_te_t = torch.from_numpy(y_te).to(dev)
    tiers = {"exact_cold": [], "lowrank_cold": []}
    rmse16 = {}
    for order in ("exact", "lowrank", "lowrank", "exact"):
        extra = kw if order == "lowrank" else dict(tile_size=TILE, device=dev)
        gp = GaussianProcess(x_tr, y_tr, **extra)
        mean, t = wall_s(lambda: gp.predict(x_te))
        tiers[f"{order}_cold"].append(t)
        rmse16[order] = float(((mean.double() - y_te_t) ** 2).mean().sqrt())
        del gp
    emit("timing.lowrank_vs_exact_gp16k", seconds=tiers, test_rmse=rmse16, m_inducing=LR_M_INDUCING,
         order="exact, lowrank, lowrank, exact", note="informative: what the tier trades for its speed")
    torch.cuda.empty_cache()


def phase_lowrank_profile(x_lr, y_lr, x_lt, x_lw, y_lw, dev):
    """One cold low-rank build (+ head), and one sliding-window step (+ warm predict)."""
    from repro_torch.core import GaussianProcess, lowrank

    kw = dict(tile_size=TILE, method="lowrank", m_inducing=LR_M_INDUCING, device=dev)
    gp = GaussianProcess(x_lr, y_lr, **kw)
    profile_call("profile.lowrank", "predict (cold), gp_256k_lowrank", lambda: gp.predict(x_lt))
    del gp
    n = LR_N_TRAIN
    u_pin = lowrank.select_inducing(torch.from_numpy(x_lw[:n]).to(dev), LR_M_INDUCING)[0]
    win = GaussianProcess(x_lw[:n], y_lw[:n], sliding_window=n, inducing=u_pin, **kw)
    win.predict(x_lt)
    new = slice(n, n + TILE)

    def step():
        win.update(x_lw[new], y_lw[new])
        return win.predict(x_lt)

    profile_call("profile.lowrank_step", "update(512) (absorb + exact eviction) + predict (warm), "
                 "gp_256k_lowrank sliding window", step)
    check(win._lowrank_warm(), "the profiled low-rank step fell back to a rebuild")
    del win
    torch.cuda.empty_cache()


def attention_pairs(s: int, t: int, window) -> int:
    """Unmasked (query, key) pairs of the causal mask (top-left aligned), within ``window`` if given."""
    rows = np.arange(s, dtype=np.int64)
    lo = np.zeros_like(rows) if window is None else np.maximum(rows - window + 1, 0)
    return int(np.maximum(np.minimum(rows + 1, t) - lo, 0).sum())


def flash_phase(dev):
    """The flash kernel against its plain version at gemma2-2b's shapes; timed beside SDPA.

    The served prefill's attention (B = 4, S = T = 2048, 8 query heads on 4
    KV heads, hd = 256, softcap 50, bf16); the window of the local layers
    at S = 8192; a ragged S; and float32 with scores large enough for the
    softcap to bite.
    """
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ops

    cfg = configs.get_config(LM_ARCH)
    h, kv, hd, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.attn_softcap
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def inputs(b, s, dtype, q_scale):
        q = torch.randn(b, s, h, hd, generator=gen, device=dev) * q_scale
        k, v = (torch.randn(b, s, kv, hd, generator=gen, device=dev) for _ in range(2))
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def cost(b, s, window, dtype):
        """(bytes, operations) the call needs: q, k, v read and o written once; 4 hd FLOP per unmasked pair."""
        size = 2 if dtype == bf else 4
        nbytes = (2 * b * s * h * hd + 2 * b * s * kv * hd) * size
        return nbytes, 4 * hd * attention_pairs(s, s, window) * b * h

    errs, scaled, extra = {}, {}, {}
    for name, (b, s, dt, local, qs, tol) in FLASH_CASES.items():
        win = cfg.window if local else None
        q, k, v = inputs(b, s, dt, qs)
        out = ops.flash_attention(q, k, v, softcap=cap, window=win)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, softcap=cap, window=win).float()
        errs[name] = max_err(out, ref)
        # |out - ref| / max(1, |ref|): a bf16 ulp grows with |ref|
        scaled[name] = float(((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max())
        check(scaled[name] <= tol, f"flash_attention {name}: kernel disagrees with its plain version: "
              f"{scaled[name]} > {tol} (scaled), {errs[name]} (absolute)")
        del ref
        if name == next(iter(FLASH_CASES)):
            served = (q, k, v)
        else:
            nb, no = cost(b, s, win, dt)
            bnd = bound_ms(nb, no, PEAK_BF16_FLOPS if dt == bf else PEAK_FP32_FLOPS)
            extra[name] = {"ms": cuda_ms(lambda: ops.flash_attention(q, k, v, softcap=cap, window=win), 3),
                           "bound_ms": bnd[0], "bound_by": bnd[1]}
        del q, k, v, out
    q, k, v = served
    b, s = q.shape[:2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in served)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    err_sdpa = max_err(sdpa().transpose(1, 2), ops.flash_attention(q, k, v))
    nb, no = cost(b, s, None, bf)
    bnd = bound_ms(nb, no, PEAK_BF16_FLOPS)
    row = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:33", max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: ops.flash_attention(q, k, v, softcap=cap), 10),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, softcap=cap), 3),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=cuda_ms(sdpa, 10),
    )
    ms_no_cap = cuda_ms(lambda: ops.flash_attention(q, k, v), 10)
    emit("kernel.flash", shape={"B": b, "S": s, "T": s, "H": h, "KV": kv, "hd": hd, "softcap": cap,
                                "dtype": "bfloat16"},
         max_abs_err=errs, max_scaled_err=scaled, tol={"bfloat16": 2e-2, "float32": 5e-5},
         tol_rule="max |kernel - plain| / max(1, |plain|) <= tol",
         tol_reason="both sides compute float32 scores and softmax; bf16: the kernel rounds P to bf16 for "
         "the tensor cores (2^-9 of each weight) and both round the output to bf16 (one ulp is up to "
         "2^-7 |o|): the reference's bf16 tolerance, 2e-2, per unit of max(1, |o|); float32: sums of "
         "exp-weighted terms in another order, the reference's 5e-5",
         ms_no_softcap=ms_no_cap, sdpa_vs_kernel_no_softcap_max_abs_err=err_sdpa,
         softcap_over_no_softcap=row["ms"] / ms_no_cap, no_softcap_over_sdpa=ms_no_cap / row["library_ms"],
         achieved_tflops=no / row["ms"] / 1e9, achieved_tflops_no_softcap=no / ms_no_cap / 1e9, other_shapes=extra,
         library_call="torch.nn.functional.scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
         "on (B, H, S, hd) copies, no softcap: compare it with ms_no_softcap",
         **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    del served, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    row[f"{LM_REC_FLASH[0]}_b{LM_REC_FLASH[1]}_s{LM_REC_FLASH[2]}"] = flash_recurrent_case(dev)
    row["lm_shapes"] = flash_lm_shapes(dev)
    flash_build_quality()
    return row


def flash_recurrent_case(dev):
    """The flash kernel at recurrentgemma-2b's local layers (10 query heads on one KV head, hd 256, window 2048,
    no softcap, bf16) against its plain version, timed beside its bound and SDPA under the same windowed mask."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ops

    arch, b, s = LM_REC_FLASH
    cfg = configs.get_config(arch)
    h, kv, hd, win = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.window
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, s, kv, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    out = ops.flash_attention(q, k, v, window=win)
    ref = fa.flash_attention_plain(q, k, v, window=win).float()
    err = max_err(out, ref)
    scaled = float(((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max())
    check(scaled <= 2e-2, f"flash_attention {arch}: kernel disagrees with its plain version: {scaled} > 2e-2 "
          f"(scaled), {err} (absolute)")
    del ref
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    idx = torch.arange(s, device=dev)
    mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - win)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    nb = (2 * b * s * h * hd + 2 * b * s * kv * hd) * 2
    no = 4 * hd * attention_pairs(s, s, win) * b * h
    bnd = bound_ms(nb, no, PEAK_BF16_FLOPS)
    res = dict(shape={"B": b, "S": s, "T": s, "H": h, "KV": kv, "hd": hd, "window": win, "softcap": None,
                      "dtype": "bfloat16"},
               max_abs_err=err, max_scaled_err=scaled, tol=2e-2,
               ms=cuda_ms(lambda: ops.flash_attention(q, k, v, window=win), 10),
               plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, window=win), 3),
               bound_ms=bnd[0], bound_by=bnd[1], library_ms=cuda_ms(sdpa, 10),
               sdpa_vs_kernel_max_abs_err=max_err(sdpa().transpose(1, 2), out))
    res["achieved_tflops"] = no / res["ms"] / 1e9
    emit("kernel.flash.recurrentgemma", arch=arch, **res,
         library_call="torch.nn.functional.scaled_dot_product_attention(attn_mask=the windowed causal mask, "
         "enable_gqa=True) on (B, H, S, hd) copies")
    del q, k, v, qt, kt, vt, out
    torch.cuda.empty_cache()
    return res


def flash_build_quality() -> None:
    """The bf16 kernel runs on wgmma in every instantiation, without spills or serialized wgmma."""
    from repro_torch.kernels import _build, flash_attention as fa

    lib = _build.load("flash_attention")
    ptxas = ptxas_report("flash_attention", flash_label)
    hgmma = sass_mma_counts("flash_attention", flash_label, ops=("HGMMA",))
    log = _build.build_log("flash_attention")
    serialized, ignored = len(re.findall(r"\(C7512\)", log)), len(re.findall(r"\(C7508\)", log))
    ctas = {f"hd{hd}": lib.flash_bf16_ctas_per_sm(hd) for hd in fa.HEAD_DIMS}
    emit("kernel.flash.extra", names="flash_wgmma_kernel<hd> (bf16), flash_f32_kernel<hd> (float32)",
         ptxas=ptxas, sass_hgmma_count=hgmma, ctas_per_sm=ctas,
         registers_after_setmaxnreg={"consumer_warpgroups": 240, "producer_warpgroup": 24},
         ptxas_wgmma_serialized_warnings=serialized, ptxas_setmaxnreg_ignored_warnings=ignored,
         note="ptxas reports the launch's 168 registers a thread; setmaxnreg moves them to the consumers")
    check_build_quality("flash_attention", ptxas, sass_mma_counts("flash_attention", flash_label))
    bf16 = {k: v for k, v in ptxas.items() if k.startswith("bf16")}
    check(len(bf16) == len(fa.HEAD_DIMS) and all(v.get("spill_store_bytes") == 0 and v.get("spill_load_bytes") == 0
                                                for v in bf16.values()),
          f"flash_attention: ptxas reports spills in a bf16 instantiation, or one is missing: {bf16}")
    check(all(hgmma.get(k, 0) > 0 for k in bf16), f"flash_attention: no HGMMA in a bf16 instantiation: {hgmma}")
    check(serialized == 0 and ignored == 0,
          f"flash_attention: ptxas serialized wgmma ({serialized}) or ignored setmaxnreg ({ignored})")
    check(all(n >= 1 for n in ctas.values()), f"flash_attention: a bf16 instantiation does not fit an SM: {ctas}")


def serve(prefill, decode, model, prompts, steps, feed=None):
    """One batch of requests through the serving path: prefill, then ``steps`` decode steps.

    Greedy (each step feeds the argmax of the last logits), or fed the
    tokens ``feed`` (B, steps).  The launch counts are set to 0 before the
    prefill and before each step and read after it.
    """
    from repro_torch.kernels import ops

    b, s = prompts.shape[:2]
    ops.reset_launch_counts()
    (logits, caches), t_prefill = wall_s(lambda: prefill(model, prompts, cache_len=s + steps))
    counts = [ops.launch_counts()]
    tok = logits.argmax(-1) if feed is None else feed[:, 0]
    fed, step_logits, t_steps = [], [], []
    for i in range(steps):
        fed.append(tok)
        ops.reset_launch_counts()
        (lg, caches), t = wall_s(lambda: decode(model, tok[:, None], s + i, caches))
        counts.append(ops.launch_counts())
        step_logits.append(lg)
        t_steps.append(t)
        if i + 1 < steps:
            tok = lg.argmax(-1) if feed is None else feed[:, i + 1]
    return dict(logits=logits, step_logits=step_logits, fed=torch.stack(fed, 1), counts=counts,
                prefill_s=t_prefill, step_s=t_steps)


# decode against the full forward: float32 bound, and the bf16 rule
LM_TOL32 = 1e-3
LM_RULE = ("float32: |decode - full forward| <= 1e-3 (float32 sums in another order: prefill and decode "
           "run other GEMM shapes); bf16: |decode_bf16 - full_f32| <= 2 |full_bf16 - full_f32| + 1e-3, "
           "the bf16 decode no worse than twice the bf16 full forward's own rounding")


def extended(model, cfg, prompt, fed):
    """The prompt followed by the fed tokens: token ids, or, for the embeddings input, the prompt's embeddings
    followed by ``embed[fed]`` in the activation type."""
    from repro_torch.models import transformer as tf

    if not prompt.is_floating_point():
        return torch.cat([prompt, fed], 1)
    dt = tf._dtype(cfg.activation_dtype)
    return torch.cat([prompt.to(dt), model.embed[fed].to(dt)], 1)


LM_CHECKED = (0, LM_STEPS - 1)  # the decode steps held to a full forward: the first and the last


def full_forwards(model, cfg, prompts, runs, routes=None):
    """{batch: {step: the full forward's last logits over the prompt and the tokens fed up to that step}}.  With
    ``routes`` (a dict), ``routes[batch][step]`` gets the MoE routing records of that forward."""
    from repro_torch.models import moe
    from repro_torch.train import serve_step

    prefill = serve_step.make_prefill_step(cfg)[0]
    out = {}
    for bs, r in runs.items():
        seq = extended(model, cfg, prompts[bs], r["fed"])
        out[bs] = {}
        for i in LM_CHECKED:
            with moe.recording() as rec:
                out[bs][i] = prefill(model, seq[:, :bs[1] + i + 1])[0]
            if routes is not None:
                routes.setdefault(bs, {})[i] = rec
        del seq
    return out


def hold_decode_to_f32(phase, model32, cfg32, prompts, runs, full16, note=None, routes16=None):
    """``LM_RULE``: each served batch's bf16 decode (``runs``, ``full16``: its full forwards) against the float32
    model ``model32``, which serves the same tokens.  With ``routes16`` (the MoE routing of the bf16 full forwards;
    ``runs`` carry their decode steps') a row is held only where every run compared routes its token alike in every
    layer (the same experts, every choice kept); the others are reported with their drops and flips."""
    from repro_torch.models import moe
    from repro_torch.train import serve_step

    n_attn = attention_layers(cfg32)
    (prefill32, _), (decode32, _) = serve_step.make_prefill_step(cfg32), serve_step.make_decode_step(cfg32)
    held = 0
    for bs, r in runs.items():
        seq = extended(model32, cfg32, prompts[bs], r["fed"])
        with moe.recording() as rec32:
            r32 = serve(prefill32, decode32, model32, prompts[bs], LM_STEPS, feed=r["fed"])
        check(r32["counts"][0]["flash_attention"] == n_attn, f"{cfg32.name}: float32 prefill {bs}: {r32['counts'][0]}")
        res = {}
        for i in LM_CHECKED:
            with moe.recording() as full_rec:
                full32 = prefill32(model32, seq[:, :bs[1] + i + 1])[0]
            e = res[f"token_{bs[1] + i}"] = {}
            rows = torch.ones(bs[0], dtype=torch.bool, device=full32.device)
            if routes16 is not None:
                layers = cfg32.n_layers
                e["routing"] = compare_routes({"decode_bf16": step_routes(r["routes"], i, layers),
                                               "full_bf16": last_routes(routes16[bs][i], bs[0]),
                                               "decode_f32": step_routes(rec32, i, layers),
                                               "full_f32": last_routes(full_rec, bs[0])})
                rows = torch.tensor(e["routing"]["alike_rows"], device=full32.device)
            e["rows_held"] = int(rows.sum())
            if e["rows_held"]:
                dec16, f16, dec32, f32 = (t[rows] for t in (r["step_logits"][i], full16[bs][i], r32["step_logits"][i],
                                                            full32))
                e.update(gap_f32=max_err(dec32, f32), gap_bf16=max_err(dec16, f16),
                         decode_bf16_vs_full_f32=max_err(dec16, f32), full_bf16_vs_full_f32=max_err(f16, f32),
                         max_abs_logit_f32=float(f32.abs().max()))
        emit(phase, arch=cfg32.name, batch=list(bs), positions=[bs[1] + i for i in LM_CHECKED], errors=res,
             tol_f32=LM_TOL32, rule=LM_RULE, note=note)
        for pos, e in res.items():
            if not e["rows_held"]:
                continue
            held += e["rows_held"]
            check(e["gap_f32"] <= LM_TOL32,
                  f"{cfg32.name} {bs} {pos}: float32 decode off the full forward by {e['gap_f32']}")
            bound16 = 2 * e["full_bf16_vs_full_f32"] + LM_TOL32
            check(e["decode_bf16_vs_full_f32"] <= bound16, f"{cfg32.name} {bs} {pos}: bf16 decode off the float32 "
                  f"full forward by {e['decode_bf16_vs_full_f32']} > {bound16}")
        del seq
    check(held > 0, f"{phase} {cfg32.name}: no row was held to {LM_RULE}")
    return held


def decode_vs_full_forward(phase, model, cfg, prompts, runs):
    """Each served batch's decoded logits at its first and last step against a full forward over the same tokens:
    bf16, then with the weights cast to float32 and the same tokens fed (``LM_RULE``)."""
    full16 = full_forwards(model, cfg, prompts, runs)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    model32 = copy.deepcopy(model).float()
    model32.cfg = cfg32
    hold_decode_to_f32(phase, model32, cfg32, prompts, runs, full16)
    del model32, full16
    torch.cuda.empty_cache()


def phase_lm(dev):
    """gemma2-2b at full width serves two batches; launches, finiteness and decode against the full forward."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.train import serve_step

    cfg = configs.get_config(LM_ARCH)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model, t_init = wall_s(lambda: tf.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    n_params = sum(p.numel() for p in model.parameters())
    emit("lm.model", arch=LM_ARCH, config="src/repro/configs/gemma2_2b.py (full width, not cut)",
         n_layers=cfg.n_layers, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_],
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, window=cfg.window, params=n_params,
         param_count_config=cfg.param_count(), dtype=cfg.param_dtype, seed=SEED, init_seconds=t_init,
         weights_gib=(torch.cuda.memory_allocated() - base) / 2**30)
    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    rng = np.random.default_rng(SEED)
    prompts = {bs: torch.from_numpy(rng.integers(0, cfg.vocab_size, bs)).to(dev) for bs in LM_BATCHES}

    # the path: each batch served, every launch counted
    total = dict(NO_LAUNCHES)
    runs = {}
    for bs in LM_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        r = serve(prefill, decode, model, prompts[bs], LM_STEPS)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for c in r["counts"]:
            total = {k: total[k] + c[k] for k in total}
        runs[bs] = r
        outs = [r["logits"], *r["step_logits"]]
        finite = all(bool(torch.isfinite(t.float()).all()) for t in outs)
        shapes = {tuple(t.shape) for t in outs}
        flash = [c["flash_attention"] for c in r["counts"]]
        emit("lm.serve", batch=list(bs), steps=LM_STEPS, flash_launches_prefill=flash[0],
             flash_launches_per_step=flash[1:], launches_prefill=r["counts"][0], finite=finite,
             shapes=sorted(shapes), tokens_first_request=r["fed"][0].tolist(), prefill_seconds=r["prefill_s"],
             step_seconds=r["step_s"], peak_memory_gib=r["peak_gib"])
        check(flash[0] == cfg.n_layers, f"prefill {bs}: {flash[0]} flash launches, not {cfg.n_layers}")
        check(not any(flash[1:]), f"decode {bs}: flash launched in a decode step: {flash[1:]}")
        check(r["counts"][0] == {**NO_LAUNCHES, "flash_attention": cfg.n_layers},
              f"prefill {bs}: unexpected launches {r['counts'][0]}")
        check(finite and shapes == {(bs[0], cfg.vocab_size)}, f"serve {bs}: non-finite or misshapen logits {shapes}")
    check(total["flash_attention"] > 0, f"the flash kernel never launched on the serving path: {total}")

    decode_vs_full_forward("lm.decode_vs_full_forward", model, cfg, prompts, runs)
    return model, cfg, prompts, total


def phase_lm_timing(model, cfg, prompts, dev):
    """Prefill wall time and tokens/s, decode ms per step, peak memory; a second serve of each batch."""
    from repro_torch.train import serve_step

    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    res = {}
    for bs in LM_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        r = serve(prefill, decode, model, prompts[bs], LM_STEPS)
        steps = sorted(r["step_s"])
        res[f"b{bs[0]}_s{bs[1]}"] = {
            "prefill_seconds": r["prefill_s"], "prefill_tokens_per_s": bs[0] * bs[1] / r["prefill_s"],
            "decode_ms_per_step_median": 1e3 * steps[len(steps) // 2],
            "decode_ms_per_step_mean": 1e3 * sum(steps) / len(steps),
            "decode_tokens_per_s": bs[0] * len(steps) / sum(steps),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
    emit("timing.lm", runs=res, steps=LM_STEPS,
         note="host clock around calls ending in torch.cuda.synchronize(); the second serve of each batch "
         "(the first, in phase lm.serve, warmed cuBLAS); peak memory includes the bf16 weights")


def phase_lm_profile(model, cfg, prompts):
    """One prefill and one decode step of the first batch under torch.profiler: flash and matmul shares."""
    from repro_torch.train import serve_step

    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    b, s = LM_BATCHES[0]
    prompt = prompts[(b, s)]
    logits, caches = prefill(model, prompt, cache_len=s + 1)
    tok = logits.argmax(-1)[:, None]
    for call, fn in ((f"prefill {b} x {s}", lambda: prefill(model, prompt, cache_len=s + 1)),
                     (f"decode step at position {s}, batch {b}", lambda: decode(model, tok, s, caches))):
        rows, busy, wall = profile_call("profile.lm", f"{call}, gemma2-2b bf16", fn)
        flash = sum(ms for name, _, ms in rows if any(k in name for k in FLASH_KERNEL_NAMES))
        mm = sum(ms for name, _, ms in rows if any(w in name.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
        if rows:
            emit("profile.lm.shares", call=call, flash_ms=flash, flash_share_of_busy=flash / busy,
                 matmul_ms=mm, matmul_share_of_busy=mm / busy, other_ms=busy - flash - mm,
                 flash_names=list(FLASH_KERNEL_NAMES),
                 matmul_names="kernel names holding gemm, nvjet, xmma or cutlass")
            if call.startswith("prefill"):
                check(flash > 0, f"profile.lm: the prefill profiled 0 ms of flash: no kernel named "
                      f"{FLASH_KERNEL_NAMES} among {[r[0][:60] for r in rows[:14]]}")


# ---------------------------------------------------------------------------
# The kernel zoo on the card, and hyperparameter training through the kernels
# ---------------------------------------------------------------------------

# the reference's zoo (tests/test_kernel_zoo.py::_zoo) at gp_16k's D = 16: the
# seven registered families at their default params, SE-ARD with distinct
# lengthscales on all 16 features (the zoo's se_ard2 at this width), and the
# three composites
ZOO_COMPOSITES = ("scaled_m52", "sum_m52_white", "prod_se_m32")
# training: gp_16k, matern52, TRAIN_STEPS Adam steps at TRAIN_LR through the blocked reverse mode;
# the composite's autodiff gradient at TRAIN_AUTODIFF_N rows
TRAIN_STEPS = 3
TRAIN_LR = 0.05
TRAIN_AUTODIFF_N = 4096
# the float32 training path against float64 dense Adam (tests/test_mll_grad.py's trajectory rule)
TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL, TRAIN_PARAM_RTOL = 1e-3, 1e-2, 2e-2


def zoo_cells():
    """name -> (kernel, params) of every family and composite the cov_tiles kernel is held to."""
    from repro_torch.core import kernels_math as km

    cells = {name: km.get_kernel(name) for name in sorted(km.KERNEL_REGISTRY)}
    cells[f"se_ard{N_FEATURES}"] = km.ARDSquaredExponential(ndim=N_FEATURES)
    cells["scaled_m52"] = km.Scaled(km.Matern52())
    cells["sum_m52_white"] = km.Sum(km.Scaled(km.Matern52()), km.White())
    cells["prod_se_m32"] = km.Product(km.SquaredExponential(), km.Matern32())
    out = {name: (k, k.default_params()) for name, k in cells.items()}
    ard = out[f"se_ard{N_FEATURES}"][0]
    out[f"se_ard{N_FEATURES}"] = (ard, km.ARDKernelParams(torch.linspace(0.5, 2.0, N_FEATURES)))
    return out


def cov_zoo_phase(x_train, x_test, dev):
    """cov_tiles for every family and composite at gp_16k's ASSEMBLE (528 tiles) and CROSS (1024) launches.

    Each against ``cov_tiles_plain`` at the tolerance the kernel states
    (``cov_assembly.cov_tiles_tolerance``), timed with CUDA events beside its
    bound (the writes: 528 MiB and 1 GiB); SE-ARD also on data offset by 10,
    where the plain version's expanded form cancels and the kernel's
    difference form does not.  Returns {family: row}.
    """
    from repro_torch.core import executor, kernels_math as km, scheduler as sch, tiling
    from repro_torch.kernels import _build, cov_assembly, ops

    m, d = TILE, N_FEATURES
    xc = tiling.pad_features(torch.from_numpy(x_train).to(dev), m)
    xtc = tiling.pad_features(torch.from_numpy(x_test).to(dev), m)
    plan = executor.program_plan(xc.shape[0], xtc.shape[0], False, None)
    n, nt = x_train.shape[0], x_test.shape[0]
    launches = {}
    for op in (sch.ASSEMBLE, sch.CROSS):
        bt = next(b for lvl in plan.levels for b in lvl if b.op == op)
        ra, rb = (torch.from_numpy(a).to(dev) for a in (bt.a, bt.b))
        xa = (xc if op == sch.ASSEMBLE else xtc)[ra]
        launches[op] = (xa, xc[rb], ra * m, rb * m, (n, n) if op == sch.ASSEMBLE else (nt, n), op == sch.ASSEMBLE)
    rows = {}
    for name, (kern, p) in zoo_cells().items():
        ard = name.startswith("se_ard")
        row = {}
        table = ops.cov_descriptor(kern, p, d, torch.float32, dev)
        for op, (xa, xb, r0, c0, (nvr, nvc), sym) in launches.items():
            def run():
                return ops.cov_tiles(xa, xb, r0, c0, nvr, nvc, p, symmetric=sym, kernel=kern, table=table)

            ops.reset_launch_counts()
            got = run()
            torch.cuda.synchronize()
            one = ops.launch_counts()["cov_tiles"]
            want = cov_assembly.cov_tiles_plain(xa, xb, r0, c0, nvr, nvc, p, symmetric=sym, kernel=kern)
            err = max_err(got, want)
            tol = cov_assembly.cov_tiles_tolerance(kern, p, xa.reshape(-1, d), xb.reshape(-1, d))
            t, mm, mb = got.shape
            del got, want
            nbytes = (xa.numel() + xb.numel() + 4 * t + t * mm * mb) * 4
            nops = t * ((3 if ard else 2) * d * mm * mb + 2 * d * (mm + mb) + 6 * mm * mb)
            bnd = bound_ms(nbytes, nops)
            key = "assemble" if sym else "cross"
            row[key] = dict(tiles=t, max_abs_err=err, tol=tol, launches_per_call=one, ms=cuda_ms(run, 10),
                            bound_ms=bnd[0], bound_by=bnd[1])
            if sym:
                row[key]["plain_ms"] = cuda_ms(
                    lambda: cov_assembly.cov_tiles_plain(xa, xb, r0, c0, nvr, nvc, p, symmetric=True, kernel=kern), 1)
            check(one == 1 and err <= tol, f"cov_tiles {name} at {key}: {one} launches, error {err} > {tol}")
        rows[name] = row
    # SE-ARD far from the origin: the plain version's cancellation, the kernel's difference form
    kern, p = zoo_cells()[f"se_ard{N_FEATURES}"]
    xa, xb, r0, c0, _, _ = launches[sch.ASSEMBLE]
    xo_a, xo_b = xa[:64] + 10.0, xb[:64] + 10.0
    got = ops.cov_tiles(xo_a, xo_b, r0[:64], c0[:64], n, n, p, symmetric=False, kernel=kern)
    want = cov_assembly.cov_tiles_plain(xo_a, xo_b, r0[:64], c0[:64], n, n, p, symmetric=False, kernel=kern)
    exact = cov_assembly.cov_tiles_plain(xa[:64].double(), xb[:64].double(), r0[:64], c0[:64], n, n, p,
                                         symmetric=False, kernel=kern)
    offset = dict(offset=10.0, tiles=64, kernel_vs_plain=max_err(got, want),
                  kernel_vs_float64_centred=max_err(got, exact), plain_vs_float64_centred=max_err(want, exact),
                  tol=cov_assembly.cov_tiles_tolerance(kern, p, xo_a.reshape(-1, d), xo_b.reshape(-1, d)))
    del got, want, exact
    lib = _build.load("cov_assembly")
    ptxas, mma = ptxas_report("cov_assembly", cov_label), sass_mma_counts("cov_assembly", cov_label)
    ctas = {"float32/vec/iso": lib.cov_tiles_f32_ctas_per_sm(0), "float32/vec/ard": lib.cov_tiles_f32_ctas_per_sm(1)}
    limits = [lib.cov_tiles_limits(i) for i in range(6)]
    want_limits = [cov_assembly.MAX_TERMS, cov_assembly.MAX_FACTORS, cov_assembly.MAX_ARD_D,
                   2 + cov_assembly.MAX_TERMS * (1 + cov_assembly.MAX_FACTORS), cov_assembly.TABLE_WIDTH,
                   km.DESC_DIAG]
    emit("kernel.cov_tiles.zoo", families=rows, ard_offset=offset, ptxas=ptxas, ctas_per_sm=ctas, sass_hmma_count=mma,
         descriptor_limits=limits,
         tol_rule=cov_assembly.cov_tiles_tolerance.__doc__.split("\n\n")[1].replace("\n", " ").strip())
    check(limits == want_limits, f"cov_tiles: the library's descriptor limits {limits} are not the wrapper's {want_limits}")
    check(offset["kernel_vs_plain"] <= offset["tol"], f"cov_tiles ARD on offset data: {offset}")
    check(all(v.get("spill_store_bytes") == 0 and v.get("spill_load_bytes") == 0 and v.get("stack_frame_bytes") == 0
              for v in ptxas.values()), f"cov_tiles: spills or a stack frame in an instantiation: {ptxas}")
    check(all(c >= 3 for c in ctas.values()), f"cov_tiles: float32 off three CTAs an SM: {ctas}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def phase_zoo(x_train, y_train, x_test, dev, trained):
    """gp_16k's cold predict_with_uncertainty on the kernels: matern52 at the trained params
    (``trained``, the GP that phase ``train`` fitted), then Sum(Scaled(Matern52), White) at its defaults."""
    from repro_torch.core import GaussianProcess, executor
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops

    by_op = executor.program_plan(N_TRAIN // TILE, N_TEST // TILE, True, None).launches_by_op()
    want = {**NO_LAUNCHES, "cov_tiles": sum(by_op.get(o, 0) for o in ("assemble", "cross", "prior")),
            "potrf": by_op["potrf"], "trsm": by_op["trsm"], "trail": by_op[executor.TRAIL]}
    total = dict(NO_LAUNCHES)
    composite = GaussianProcess(x_train, y_train, tile_size=TILE, kernel=km.Sum(km.Scaled(km.Matern52()), km.White()),
                                device=dev)
    for name, gp in (("matern52", trained), ("sum_m52_white", composite)):
        kern = gp.kernel
        ops.reset_launch_counts()
        (mean, var), t_cold = wall_s(lambda: gp.predict_with_uncertainty(x_test))
        got = ops.launch_counts()
        total = {k: total[k] + got[k] for k in total}
        mean_ref, var_ref = dense_reference(x_train, y_train, x_test, dev, kern, gp.params)
        mono = GaussianProcess(x_train, y_train, pipeline="monolithic", kernel=kern, params=gp.params, device=dev)
        (mean_d, var_d), t_mono = wall_s(lambda: mono.predict_with_uncertainty(x_test))
        e, dense, mean_bound, var_bound = accuracy_bounds(mean_ref, var_ref, mean_d, var_d)
        res = {"mean_err_tiled": e(mean, mean_ref), "var_err_tiled": e(var, var_ref), **dense}
        finite = bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
        emit("main.zoo", kernel=name, kernel_id=kern.kernel_id(), trained=gp is trained,
             params=[float(v) for v in km.tree_leaves(gp.params)], launches=got, plan=want, **res,
             mean_bound=mean_bound, var_bound=var_bound, finite=finite, min_var_tiled=float(var.min()),
             seconds={"tiled_cold_predict_with_uncertainty": t_cold, "dense_predict_with_uncertainty": t_mono},
             bound_rule=BOUND_RULE)
        check(got == want and got["cov_tiles"] > 0, f"main.zoo {name}: launches {got} differ from the plan's {want}")
        check(finite and mean.shape == var.shape == (N_TEST,), f"main.zoo {name}: non-finite or misshapen outputs")
        check(res["mean_err_tiled"] <= mean_bound and res["var_err_tiled"] <= var_bound,
              f"main.zoo {name}: errors {res} above the bounds {mean_bound}, {var_bound}")
        del mono, mean, var, mean_d, var_d, mean_ref, var_ref
    del composite
    torch.cuda.empty_cache()
    return total


def _rel_close(a, b, rtol, atol=0.0):
    return all(abs(x - y) <= atol + rtol * abs(y) for x, y in zip(a, b))


def value_and_grads(fn, params, dtype, dev):
    """(value, [d value / d leaf]) as floats of ``fn(tree, dtype)``, the params tree's leaves made live in dtype."""
    from repro_torch.core import kernels_math as km

    leaves, treedef = km.tree_flatten(params)
    live = [torch.tensor(float(v), dtype=dtype, device=dev, requires_grad=True) for v in leaves]
    val = fn(km.tree_unflatten(treedef, live), dtype)
    out = float(val.detach()), [float(g) for g in torch.autograd.grad(val, live)]
    del val
    return out


def grad_rule(g, g64, gd, rel):
    """PERF.md section 2's gradient rule, each component on its own: |g_i - g64_i| <= 2 |gd_i - g64_i| + rel |g64_i|.

    Returns (errors, bounds, ok); gd is the dense float32 gradient, g64 the float64 one.
    """
    err = [abs(a - b) for a, b in zip(g, g64)]
    bnd = [2 * abs(c - b) + rel * abs(b) for c, b in zip(gd, g64)]
    return err, bnd, all(e <= b for e, b in zip(err, bnd))


GRAD_RULE = "per component: |g_i - g64_i| <= 2 |g_dense_f32_i - g64_i| + {} |g64_i| (float64 dense autograd)"


def phase_train(x_train, y_train, dev):
    """gp_16k matern52: GaussianProcess.optimize(steps=3) through the blocked reverse mode, on the kernels.

    Held against the same three Adam steps on the float64 dense NLML on the
    card; the loss curve comes from ``mll.optimize_hyperparameters``, the
    path ``optimize`` runs, which must land on the same parameters.  Adam
    normalises each component of the gradient, so the trajectory cannot see
    a gradient's scale: the first step's gradient is also held, component by
    component, against autograd of the float64 dense NLML.  Then the
    composite Sum(Scaled(Matern52), White) (no hand-derived VJP) at n = 4096
    through autograd of the program, against the same reference.  Returns
    (launches, the trained GP).
    """
    from repro_torch.core import GaussianProcess, executor, mll
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops

    per_step = executor.program_plan(N_TRAIN // TILE, 0, False, None).launches_by_op()
    want = {**NO_LAUNCHES, "cov_tiles": per_step["assemble"], "potrf": per_step["potrf"],
            "trsm": per_step["trsm"], "trail": per_step[executor.TRAIL]}
    want = {k: TRAIN_STEPS * v for k, v in want.items()}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gp = GaussianProcess(x_train, y_train, tile_size=TILE, kernel="matern52", device=dev)
    _, t_opt = wall_s(lambda: gp.optimize(steps=TRAIN_STEPS, lr=TRAIN_LR))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    p_gp = [float(v) for v in km.tree_leaves(gp.params)]
    (p_t, l_t), t_mll = wall_s(lambda: mll.optimize_hyperparameters(
        x_train, y_train, km.SEKernelParams.paper_defaults(), steps=TRAIN_STEPS, lr=TRAIN_LR, method="tiled",
        tile_size=TILE, kernel="matern52", device=dev))
    (p_64, l_64), t_64 = wall_s(lambda: mll.optimize_hyperparameters(
        x_train, y_train, km.SEKernelParams.paper_defaults(), steps=TRAIN_STEPS, lr=TRAIN_LR, dtype=torch.float64,
        method="monolithic", kernel="matern52", device=dev))
    losses, losses64 = [float(v) for v in l_t], [float(v) for v in l_64]
    params, params64 = [float(v) for v in km.tree_leaves(p_t)], [float(v) for v in km.tree_leaves(p_64)]
    emit("train", config="gp_16k", kernel="matern52", steps=TRAIN_STEPS, lr=TRAIN_LR, vjp="custom",
         launches=launches, plan=want, losses=losses, losses_float64_dense=losses64,
         params=dict(zip(("lengthscale", "vertical", "noise"), params)),
         params_float64_dense=dict(zip(("lengthscale", "vertical", "noise"), params64)), params_optimize=p_gp,
         seconds={"optimize": t_opt, "per_step": t_opt / TRAIN_STEPS, "optimize_hyperparameters": t_mll,
                  "float64_dense_3_steps": t_64},
         peak_memory_gib=peak / 2**30,
         rule=f"losses rtol {TRAIN_LOSS_RTOL} / atol {TRAIN_LOSS_ATOL}, params rtol {TRAIN_PARAM_RTOL} "
              "(tests/test_mll_grad.py::test_tiled_optimizer_matches_monolithic_trajectory)")
    check(launches == want, f"train: launches {launches} differ from {TRAIN_STEPS} x the NLML program's {want}")
    check(_rel_close(losses, losses64, TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL), f"train: losses {losses} vs {losses64}")
    check(_rel_close(params, params64, TRAIN_PARAM_RTOL), f"train: params {params} vs {params64}")
    check(_rel_close(p_gp, params, 1e-5), f"train: GaussianProcess.optimize landed on {p_gp}, the path on {params}")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")

    def dense_grads(kern, n, p0):
        """(float64, float32) dense NLML value and gradient on the first n rows, autograd on the card."""
        return [value_and_grads(lambda p, d_: mll.negative_log_marginal_likelihood(
            x_train[:n], y_train[:n], p, dtype=d_, kernel=kern, device=dev), p0, dt, dev)
            for dt in (torch.float64, torch.float32)]

    # the first step's gradient: nlml_tiled's blocked rule at the starting params, per component
    p0 = km.SEKernelParams.paper_defaults()
    v_t, g_t = value_and_grads(lambda p, dt: mll.nlml_tiled(x_train, y_train, p, tile_size=TILE, kernel="matern52",
                                                            device=dev), p0, torch.float32, dev)
    (v64, g64), (vd, gd) = dense_grads(km.Matern52(), N_TRAIN, p0)
    torch.cuda.empty_cache()
    err, bnd, ok = grad_rule(g_t, g64, gd, 1e-3)
    emit("train.grad", config="gp_16k", kernel="matern52", vjp="custom", params=["lengthscale", "vertical", "noise"],
         value=v_t, value_float64_dense=v64, value_float32_dense=vd, grad=g_t, grad_float64_dense=g64,
         grad_float32_dense=gd, abs_err=err, bound=bnd, rule=GRAD_RULE.format("1e-3"))
    check(ok, f"train.grad: the first step's gradient {g_t} against float64 {g64}: errors {err} above {bnd}")

    # the composite through autograd of the program
    kern = km.Sum(km.Scaled(km.Matern52()), km.White())
    n = TRAIN_AUTODIFF_N
    names = ["scale", "lengthscale", "vertical", "noise", "white_noise"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    v_t, g_t = value_and_grads(lambda p, dt: mll.nlml_tiled(x_train[:n], y_train[:n], p, tile_size=TILE, kernel=kern,
                                                            device=dev), kern.default_params(), torch.float32, dev)
    c_auto = ops.launch_counts()
    peak_auto = torch.cuda.max_memory_allocated() - base
    for name, c in c_auto.items():
        launches[name] += c
    (v64, g64), (vd, gd) = dense_grads(kern, n, kern.default_params())
    err, bnd, ok = grad_rule(g_t, g64, gd, 1e-3)
    emit("train.autodiff", kernel=kern.kernel_id(), n=n, tile=TILE, vjp="autodiff", params=names,
         value=v_t, value_float64_dense=v64, value_float32_dense=vd, grad=g_t, grad_float64_dense=g64,
         grad_float32_dense=gd, abs_err=err, bound=bnd, launches=c_auto, peak_memory_gib=peak_auto / 2**30,
         rule=GRAD_RULE.format("1e-3") + " (1e-3: the reference's float32 gradient rtol, tests/test_mll_grad.py)")
    check(all(c_auto[k] > 0 for k in MAIN_KERNELS), f"train.autodiff: a kernel did not launch: {c_auto}")
    check(ok, f"train.autodiff: gradient errors {err} above {bnd}")
    check(abs(v_t - v64) <= 2 * abs(vd - v64) + 1e-5 * abs(v64), f"train.autodiff: value {v_t} vs {v64}")
    torch.cuda.empty_cache()
    return launches, gp


def phase_train_profile(x_train, y_train, dev):
    """Where one training step's time goes (gp_16k matern52): forward program, K^-1, dense contraction."""
    from repro_torch.core import mll, tiling
    from repro_torch.core import kernels_math as km

    kern = km.Matern52()

    def step():
        p = [torch.tensor(v, device=dev, requires_grad=True) for v in (1.0, 1.0, 0.1)]
        val = mll.nlml_tiled(x_train, y_train, km.SEKernelParams(*p), tile_size=TILE, kernel=kern, device=dev)
        return torch.autograd.grad(val, p)

    step()  # warm
    pieces = {}
    p = km.SEKernelParams(1.0, 1.0, 0.1)
    cfg = mll._Config(TILE, None, None, torch.float32, kern, dev)
    x, y = (torch.as_tensor(a, device=dev) for a in (x_train, y_train))
    (val, (lpacked, alpha_c)), pieces["forward_program"] = wall_s(
        lambda: mll._nlml_forward(cfg, x, y, p))
    n = y.shape[0]
    l, pieces["unpack_factor"] = wall_s(lambda: tiling.unpack_lower(lpacked)[:n, :n])
    kinv, pieces["kinv_cholesky_inverse"] = wall_s(lambda: torch.cholesky_inverse(l))
    del l
    _, pieces["dense_contraction"] = wall_s(lambda: mll._nlml_dense_grads(
        kern, mll._cast(p, torch.float32, dev), x, alpha_c.reshape(-1)[:n], kinv))
    del kinv
    _, pieces["whole_step"] = wall_s(step)
    emit("timing.train", config="gp_16k", kernel="matern52", seconds=pieces,
         note="host clock around each piece ending in torch.cuda.synchronize(); the backward is the "
              "factor's unpacking, K^-1 by cholesky_inverse and the contraction")
    torch.cuda.empty_cache()
    profile_call("profile.train", "one training step (nlml_tiled + backward), matern52, gp_16k", step)
    torch.cuda.empty_cache()


def dense_dtc_nlml(x, y, u, params, jitter, dtype):
    """The DTC NLML in whitened form, dense, plain torch (differentiable; a check, not a path of the port)."""
    from repro_torch.core import kernels_math as km

    x, y, u = (a.to(dtype) for a in (x, y, u))
    n = y.shape[0]
    noise = params.noise
    kuu = km.assemble_covariance(u, params, dtype=None)
    kuu = kuu + torch.diag_embed((jitter - noise) * torch.ones(u.shape[0], dtype=dtype, device=u.device))
    luu = torch.linalg.cholesky(kuu)
    w = torch.linalg.solve_triangular(luu, km.SQUARED_EXPONENTIAL.kfree(params, u, x), upper=False)
    lb = torch.linalg.cholesky(torch.eye(u.shape[0], dtype=dtype, device=u.device) + (w @ w.mT) / noise)
    z = torch.linalg.solve_triangular(lb, (w @ y)[:, None], upper=False)
    quad = torch.sum(y * y) / noise - torch.sum(z * z) / (noise * noise)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(lb)))
    return 0.5 * (quad + n * torch.log(noise) + logdet + n * math.log(2.0 * math.pi))


def phase_train_lowrank(x_lr, y_lr, dev):
    """nlml_lowrank at gp_256k_lowrank's sizes: value and gradient against a float64 dense DTC, then Adam.

    The default route (the blocked rule) is held to the rule component by
    component; the autodiff route through the build is measured beside it
    (errors, time, peak memory), not held.
    """
    from repro_torch.core import lowrank, mll
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops

    x, y = torch.from_numpy(x_lr).to(dev), torch.from_numpy(y_lr).to(dev)
    u = lowrank.select_inducing(x, LR_M_INDUCING)[0]
    p0 = km.SEKernelParams.paper_defaults()

    def route(vjp):
        """(value, gradient), seconds and peak memory (GiB) of nlml_lowrank's value and gradient by ``vjp``."""
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got, sec = wall_s(lambda: value_and_grads(lambda p, dt: mll.nlml_lowrank(
            x, y, p, m_inducing=LR_M_INDUCING, tile_size=TILE, vjp=vjp, device=dev), p0, torch.float32, dev))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.empty_cache()
        return got, sec, peak

    ops.reset_launch_counts()
    (v_t, g_t), t_vg, peak = route("custom")
    launches = ops.launch_counts()
    dense = {}
    for dt in (torch.float64, torch.float32):
        dense[dt] = value_and_grads(lambda p, d_: dense_dtc_nlml(x, y, u, p, lowrank.DEFAULT_JITTER, d_), p0, dt, dev)
        torch.cuda.empty_cache()
    (v64, g64), (vd, gd) = dense[torch.float64], dense[torch.float32]
    err, bnd, ok = grad_rule(g_t, g64, gd, 1e-4)
    (v_a, g_a), t_a, peak_a = route("autodiff")
    err_a, bnd_a, ok_a = grad_rule(g_a, g64, gd, 1e-4)
    ops.reset_launch_counts()
    (p2, l2), t_adam = wall_s(lambda: mll.optimize_hyperparameters(
        x, y, p0, steps=LR_STEPS, lr=TRAIN_LR, method="lowrank", m_inducing=LR_M_INDUCING, tile_size=TILE,
        device=dev))
    c_adam = ops.launch_counts()
    for k, c in c_adam.items():
        launches[k] += c
    emit("train.lowrank", config="gp_256k_lowrank", n=LR_N_TRAIN, m_inducing=LR_M_INDUCING, vjp="custom",
         params=["lengthscale", "vertical", "noise"], value=v_t, value_float64_dense=v64, value_float32_dense=vd,
         grad=g_t, grad_float64_dense=g64, grad_float32_dense=gd, abs_err=err, bound=bnd,
         rel_err_by_component=[abs(a - b) / abs(b) for a, b in zip(g_t, g64)],
         rel_err_by_component_float32_dense=[abs(a - b) / abs(b) for a, b in zip(gd, g64)],
         vjp_autodiff={"value": v_a, "grad": g_a, "abs_err": err_a, "within_rule": ok_a, "seconds": t_a,
                       "peak_memory_gib": peak_a,
                       "rel_err_by_component": [abs(a - b) / abs(b) for a, b in zip(g_a, g64)]},
         adam_losses=[float(v) for v in l2], adam_params=[float(v) for v in km.tree_leaves(p2)],
         launches=launches, seconds={"value_and_grad": t_vg, "adam_steps": t_adam}, peak_memory_gib=peak,
         rule=GRAD_RULE.format("1e-4") + " against a dense DTC; value: |v - v64| <= 2 |v_dense_f32 - v64| + 1e-6 |v64|")
    check(launches["lrgemm"] > 0 and launches["cov_tiles"] > 0 and c_adam["lrgemm"] > 0,
          f"train.lowrank: lrgemm or cov_tiles never launched: {launches}")
    check(ok, f"train.lowrank: gradient {g_t} against float64 {g64}: errors {err} above {bnd}")
    check(abs(v_t - v64) <= 2 * abs(vd - v64) + 1e-6 * abs(v64), f"train.lowrank: value {v_t} vs {v64}")
    check(all(math.isfinite(v) for v in l2) and l2[-1] < l2[0], f"train.lowrank: Adam losses {l2}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Fleets: GPBatch (B problems of one size) and GPFleet (ragged sizes, buckets)
# ---------------------------------------------------------------------------

# fleet.batch: B = 16 problems of gp_16k's family cut to n = 4096 (fig9's batched fleet at the H100's tile)
FLEET_B, FLEET_N, FLEET_NT = 16, 4096, 1024
# fleet.batch.lowrank: B = 8 problems of n = 32768 on the Nystrom tier
FLEET_LR_B, FLEET_LR_N, FLEET_LR_NT, FLEET_LR_M = 8, 32768, 2048, 1024
# fleet.ragged: fig11's skewed mix, B = 32 sizes log-uniform in [512, 16384]
RAGGED_B, RAGGED_LO, RAGGED_HI, RAGGED_NT = 32, 512, 16384, 1024
# a fleet against the same problems run one by one on the card: float32 both, with the sums of
# other launch geometries (B * G tiles, a bucket's padded capacity) rounding in another order
FLEET_VS_SINGLE_TOL = 1e-3


def fleet_data(b, n, nt, seed0):
    """B problems of ``make_data`` with seeds seed0 + i, stacked: x (B, n, D), y (B, n), x_test, y_test."""
    parts = [make_data(n, nt, N_FEATURES, seed0 + i) for i in range(b)]
    return tuple(np.stack(p) for p in zip(*parts))


def skewed_sizes(b, lo, hi, rng):
    """fig11's mix (benchmarks/fig11_ragged_fleet.py): log-uniform sizes in [lo, hi], both ends pinned."""
    ns = np.exp(rng.uniform(np.log(lo), np.log(hi), b)).astype(int)
    ns[ns < lo] = lo
    ns[0], ns[-1] = lo, hi
    return np.sort(ns)


def fleet_single_errors(mean, var, singles):
    """Largest |fleet - single GP| of the means and the variances over the problems."""
    em = max(max_err(mean[i], s[0]) for i, s in enumerate(singles))
    ev = max(max_err(var[i], s[1]) for i, s in enumerate(singles))
    return em, ev


def fleet_accuracy(idx, xs, ys, xt, mean, var, dev):
    """Each listed problem of a fleet against a float64 dense solve, under the main phase's rule."""
    from repro_torch.core import GaussianProcess

    out = []
    for i in idx:
        mean_ref, var_ref = dense_reference(xs[i], ys[i], xt[i], dev)
        mono = GaussianProcess(xs[i], ys[i], pipeline="monolithic", device=dev)
        mean_d, var_d = mono.predict_with_uncertainty(xt[i])
        e, dense, mean_bound, var_bound = accuracy_bounds(mean_ref, var_ref, mean_d, var_d)
        row = dict(problem=int(i), n=int(len(ys[i])), mean_err=e(mean[i], mean_ref), var_err=e(var[i], var_ref),
                   mean_bound=mean_bound, var_bound=var_bound, **dense)
        out.append(row)
        check(row["mean_err"] <= mean_bound and row["var_err"] <= var_bound,
              f"fleet problem {i} (n = {len(ys[i])}) outside the accuracy rule: {row}")
    return out


FLEET_CHECKED = ("cov_tiles", "potrf", "trsm", "trail", "carry_update", "lrgemm", "tile_gemv", "tile_trsv")


def vector_launches(by_op):
    """The tile_gemv and tile_trsv launches of one run of a fleet's program plan."""
    return {"tile_gemv": sum(by_op.get(o, 0) for o in ("gemv", "gemv_b", "xgemv")),
            "tile_trsv": sum(by_op.get(o, 0) for o in ("trsv", "trsv_b"))}


def without_vector(counts):
    """Launch counts but the fleets' tile_gemv and tile_trsv (checked by their widest launch and in fleet.batch)."""
    return {k: v for k, v in counts.items() if k not in VECTOR_KERNELS}


@contextlib.contextmanager
def widest_launches():
    """Within the block, a copy of the operands of each kernel op's widest launch (the most tiles).

    The ops are wrapped where the executor looks them up, in
    ``repro_torch.kernels.ops``; every call goes on to the op itself, which
    launches as it always does.  An op bumps its count under its module
    name, the wrapper's while the block runs: the wrapper carries a count,
    added to the op's on the way out.  Yields ``{op: (tiles, args,
    kwargs)}``, filled as the block runs.
    """
    from repro_torch.kernels import ops

    kept, originals = {}, {name: getattr(ops, name) for name in FLEET_CHECKED}

    def copied(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def wrap(name, op):
        def capture(*args, **kw):
            lead = args[2] if name == "lrgemm" else args[0]
            g = lead.shape[0] * lead.shape[1] if name in VECTOR_KERNELS else lead.shape[0]
            if g > kept.get(name, (0,))[0]:
                kept[name] = (g, [copied(a) for a in args], {k: copied(v) for k, v in kw.items()})
            return op(*args, **kw)
        capture.launches = 0
        return capture

    for name, op in originals.items():
        setattr(ops, name, wrap(name, op))
    try:
        yield kept
    finally:
        for name, op in originals.items():
            if hasattr(op, "launches"):
                op.launches += getattr(ops, name).launches
            setattr(ops, name, op)


def held_to_plain(path, kept, dev):
    """Each kept launch through its op and its plain version, at the tolerance of the kernel's main row.

    cov_tiles 1e-5 (SE; the fleet paths run SE), POTRF 1e-4 m, TRSM and
    TRAIL 1e-3, the carry 1e-3 and LRGEMM 1e-4 times max(1, max|plain|).
    Also the TRSM strip and the TRAIL variant the launch's tile count
    picked.  Fails on a disagreement; returns ``{op: row}``.
    """
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import (_build, carry_update, cov_assembly, lrgemm_tile, ops, potrf_tile,
                                     tile_gemv_trsv, trailing_update, trsm_tile)

    def trail_plain(c, a, b, update_dtype=None):
        if update_dtype is not None:
            a, b = a.to(update_dtype), b.to(update_dtype)
        return trailing_update.trail_plain(c, a, b)

    def cov_plain(*args, table=None, **kw):
        return cov_assembly.cov_tiles_plain(*args, **kw)

    plain = {"cov_tiles": cov_plain, "potrf": potrf_tile.potrf_plain, "trsm": trsm_tile.trsm_plain,
             "trail": trail_plain, "carry_update": carry_update.carry_update_plain, "lrgemm": lrgemm_tile.lrgemm_plain,
             "tile_gemv": tile_gemv_trsv.tile_gemv_plain, "tile_trsv": tile_gemv_trsv.tile_trsv_plain}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for name, (g, args, kw) in sorted(kept.items()):
        got = getattr(ops, name)(*args, **kw)
        want = plain[name](*args, **kw)
        err = max_err(got, want)
        scale = max(1.0, float(want.abs().max()))
        m = args[0].shape[1]
        tol = {"cov_tiles": 1e-5, "potrf": 1e-4 * m, "trsm": 1e-3, "trail": 1e-3,
               "carry_update": 1e-3 * scale, "lrgemm": 1e-4 * scale, "tile_gemv": 1e-4 * scale,
               "tile_trsv": 1e-3 * scale}[name]
        row = dict(tiles=g, shape=list(got.shape), max_abs_err=err, tol=tol)
        if name == "cov_tiles":
            row["symmetric"] = kw["symmetric"]
            check(isinstance(km.resolve_kernel(kw.get("kernel")), km.SquaredExponential),
                  f"{path}: cov_tiles checked at SE's tolerance on another family")
        if name == "trsm":
            row["strip_rows"] = _build.load("trsm_tile").trsm_strip(g, m, int(got.dtype == torch.float64), sms)
        if name == "trail":
            row["variant_big_vec"] = trailing_update.trail_variant(g, m, args[1].dtype)
        rows[name] = row
        del got, want
        check(err <= tol, f"{path}: {name} at its widest launch ({g} tiles) disagrees with its plain version: {row}")
    kept.clear()
    torch.cuda.empty_cache()
    return rows


def cov_per_problem_phase(xb, dev):
    """cov_tiles with per-problem hyperparameters at fleet.batch's ASSEMBLE launch (B = 16 x 36 tiles).

    Per-problem lengthscales 0.5 ... 2.0 (the kernel's table holds 16 rows)
    for SE, Matérn 5/2 and Sum(Scaled(Matern52), White), each against
    ``cov_tiles_plain`` at the kernel's stated tolerance (the largest over
    the problems), timed beside its bound (the writes, 576 MiB) and beside
    the same stack with shared params (a table of one row).
    """
    from repro_torch.core import executor, kernels_math as km, scheduler as sch, tiling
    from repro_torch.kernels import cov_assembly, ops

    m, d = TILE, N_FEATURES
    xc = tiling.pad_features(torch.from_numpy(xb).to(dev), m)  # (B, M, m, D)
    b, m_tiles = xc.shape[:2]
    asm = next(bt for lvl in executor.program_plan(m_tiles, 0, False, None).levels for bt in lvl
               if bt.op == sch.ASSEMBLE)
    ra, rb = (torch.from_numpy(a).to(dev) for a in (asm.a, asm.b))
    g = ra.shape[0]
    xa = xc.index_select(1, ra).reshape(b * g, m, d)
    xbb = xc.index_select(1, rb).reshape(b * g, m, d)
    r0, c0 = (ra * m).repeat(b), (rb * m).repeat(b)
    t, n = b * g, xb.shape[1]
    ls = torch.linspace(0.5, 2.0, b, device=dev)

    def cells(l):
        return {
            "se": ("se", km.SEKernelParams(l, 1.0, 0.1)),
            "matern52": ("matern52", km.SEKernelParams(l, 1.0, 0.1)),
            "sum_m52_white": (km.Sum(km.Scaled(km.Matern52()), km.White()),
                              (km.ScaledParams(1.0, km.SEKernelParams(l, 1.0, 0.1)), km.WhiteKernelParams(0.1))),
        }

    nbytes = (xa.numel() + xbb.numel() + 4 * t + t * m * m) * 4
    bnd = bound_ms(nbytes, t * (2 * d * m * m + 2 * d * 2 * m + 6 * m * m))
    rows = {}
    for name, (kern, p) in cells(ls).items():
        shared_p = cells(1.0)[name][1]
        table = ops.cov_descriptor(kern, p, d, torch.float32, dev)
        shared = ops.cov_descriptor(kern, shared_p, d, torch.float32, dev)

        def run(params=p, tab=table):
            return ops.cov_tiles(xa, xbb, r0, c0, n, n, params, symmetric=True, kernel=kern, table=tab)

        ops.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()["cov_tiles"]
        want = cov_assembly.cov_tiles_plain(xa, xbb, r0, c0, n, n, p, symmetric=True, kernel=kern)
        err = max_err(got, want)
        del got, want
        tol = max(cov_assembly.cov_tiles_tolerance(kern, km.gather_params(p, i, kern), xa[i * g:(i + 1) * g].reshape(-1, d),
                                                   xbb[i * g:(i + 1) * g].reshape(-1, d)) for i in range(b))
        rows[name] = dict(tiles=t, problems=table.problems, table_rows=int(table.launches[0].table.shape[0]),
                          launches_per_call=launches, max_abs_err=err, tol=tol, ms=cuda_ms(run, 10),
                          shared_params_ms=cuda_ms(lambda: run(shared_p, shared), 10),
                          plain_ms=cuda_ms(lambda: cov_assembly.cov_tiles_plain(
                              xa, xbb, r0, c0, n, n, p, symmetric=True, kernel=kern), 1),
                          bound_ms=bnd[0], bound_by=bnd[1])
        check(launches == 1 and table.problems == b, f"cov_tiles per-problem {name}: {launches} launches, "
              f"{table.problems} table rows")
        check(err <= tol, f"cov_tiles per-problem {name}: error {err} above {tol}")
    emit("kernel.cov_tiles.per_problem", shape=[t, m, m, d], problems=b, tiles_per_problem=g,
         lengthscales="0.5 ... 2.0, one per problem", families=rows,
         tol_rule="cov_assembly.cov_tiles_tolerance, the largest over the problems' own params")
    torch.cuda.empty_cache()
    return rows["se"]


def phase_fleet_batch(xb, yb, xtb, dev):
    """fleet.batch: GPBatch cold and warm against a loop of single GPs and a float64 dense solve."""
    from repro_torch.core import GaussianProcess, GPBatch, executor
    from repro_torch.kernels import ops

    b = xb.shape[0]
    by_op = executor.program_plan(FLEET_N // TILE, FLEET_NT // TILE, True, None).launches_by_op()
    want_cold = {**NO_LAUNCHES, "cov_tiles": sum(by_op.get(o, 0) for o in ("assemble", "cross", "prior")),
                 "potrf": by_op["potrf"], "trsm": by_op["trsm"], "trail": by_op[executor.TRAIL],
                 **vector_launches(by_op)}
    want_warm = {**NO_LAUNCHES, "cov_tiles": 2, "tile_gemv": 1}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fleet = GPBatch(xb, yb, tile_size=TILE, device=dev)
    (mean, var), t_cold = wall_s(lambda: fleet.predict_with_uncertainty(xtb))
    c_cold = ops.launch_counts()
    ops.reset_launch_counts()
    (mean_w, var_w), t_warm = wall_s(lambda: fleet.predict_with_uncertainty(xtb))
    c_warm = ops.launch_counts()
    nl, t_nlml = wall_s(fleet.nlml)
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: c_cold[k] + c_warm[k] for k in c_cold}
    gps = [GaussianProcess(xb[i], yb[i], tile_size=TILE, device=dev) for i in range(b)]
    singles, t_loop = wall_s(lambda: [gp.predict_with_uncertainty(xtb[i]) for i, gp in enumerate(gps)])
    nl_single = [float(gp.nlml()) for gp in gps]
    em, ev = fleet_single_errors(mean, var, singles)
    emw, evw = fleet_single_errors(mean_w, var_w, singles)
    nl_err = max(abs(float(a) - s) / abs(s) for a, s in zip(nl, nl_single))
    acc = fleet_accuracy(range(b), xb, yb, xtb, mean, var, dev)
    finite = all(bool(torch.isfinite(a).all()) for a in (mean, var, mean_w, var_w, nl))
    emit("fleet.batch", config=f"GPBatch B = {b}, n = {FLEET_N}, n_test = {FLEET_NT}, tile {TILE}, D = {N_FEATURES}, SE "
         "at gp_16k's parameters, float32", launches_cold=c_cold, plan_cold=want_cold, launches_warm=c_warm,
         plan_warm=want_warm, vs_single_gps={"mean": em, "var": ev, "warm_mean": emw, "warm_var": evw,
                                              "nlml_rel": nl_err, "tol": FLEET_VS_SINGLE_TOL},
         accuracy=acc, bound_rule=BOUND_RULE, finite=finite,
         shapes=[list(t.shape) for t in (mean, var, nl)],
         seconds={"cold_predict_with_uncertainty": t_cold, "warm_predict_with_uncertainty": t_warm, "nlml": t_nlml,
                  "loop_of_single_gps_cold": t_loop},
         problems_per_s={"batch_cold": b / t_cold, "batch_warm": b / t_warm, "loop_cold": b / t_loop},
         peak_memory_gib=peak / 2**30)
    check(c_cold == want_cold and c_warm == want_warm, f"fleet.batch launches {c_cold}, {c_warm} differ from the "
          f"plan's {want_cold}, {want_warm}")
    check(finite and list(mean.shape) == [b, FLEET_NT], "fleet.batch: non-finite or misshapen outputs")
    check(max(em, ev, emw, evw) <= FLEET_VS_SINGLE_TOL and nl_err <= 1e-5,
          f"fleet.batch against single GPs: {em}, {ev}, {emw}, {evw}, nlml {nl_err}")
    del fleet, gps, singles
    torch.cuda.empty_cache()
    # each kernel's widest launch of a cold call (after the counts were read), against its plain version
    with widest_launches() as kept:
        GPBatch(xb, yb, tile_size=TILE, device=dev).predict_with_uncertainty(xtb)
    plain = held_to_plain("fleet.batch", kept, dev)
    emit("fleet.batch.kernels", widest_launches=plain)
    return launches, plain


def phase_fleet_train(xb, yb, dev):
    """fleet.batch.train: GPBatch(kernel="matern52").optimize(3 steps), each problem against float64 dense Adam."""
    from repro_torch.core import GPBatch, mll, tiling
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops

    b = xb.shape[0]
    kern = km.Matern52()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fleet = GPBatch(xb, yb, tile_size=TILE, kernel="matern52", device=dev)
    _, t_opt = wall_s(lambda: fleet.optimize(steps=TRAIN_STEPS, lr=TRAIN_LR))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    p_fleet = [v.tolist() for v in km.tree_leaves(fleet.params)]
    (p_t, l_t), t_mll = wall_s(lambda: mll.optimize_hyperparameters_batched(
        xb, yb, km.SEKernelParams.paper_defaults(), steps=TRAIN_STEPS, lr=TRAIN_LR, tile_size=TILE,
        kernel="matern52", device=dev))
    losses, params = l_t.T.tolist(), [v.tolist() for v in km.tree_leaves(p_t)]
    rows, t_64 = [], 0.0
    for i in range(b):
        (p64, l64), t = wall_s(lambda: mll.optimize_hyperparameters(
            xb[i], yb[i], km.SEKernelParams.paper_defaults(), steps=TRAIN_STEPS, lr=TRAIN_LR, dtype=torch.float64,
            method="monolithic", kernel="matern52", device=dev))
        t_64 += t
        mine = [params[k][i] for k in range(3)]
        rows.append(dict(losses=losses[i], losses_float64_dense=[float(v) for v in l64], params=mine,
                         params_float64_dense=[float(v) for v in km.tree_leaves(p64)]))
        check(_rel_close(losses[i], rows[-1]["losses_float64_dense"], TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL),
              f"fleet.batch.train problem {i}: losses {rows[-1]}")
        check(_rel_close(mine, rows[-1]["params_float64_dense"], TRAIN_PARAM_RTOL), f"fleet.batch.train problem {i}: {rows[-1]}")
    check(all(_rel_close(a, c, 1e-5) for a, c in zip(p_fleet, params)), "fleet.batch.train: GPBatch.optimize "
          f"landed on {p_fleet}, the path on {params}")
    check(all(len(v) == b for v in p_fleet), "fleet.batch.train: the leaves are not per-problem")
    check(all(launches[k] > 0 for k in MAIN_KERNELS), f"fleet.batch.train: a kernel did not launch: {launches}")
    # one step's pieces: the forward program, K^-1 of the B factors, the per-problem contraction
    cfg = mll._Config(TILE, None, None, torch.float32, kern, dev)
    x, y = (torch.as_tensor(a, device=dev) for a in (xb, yb))
    n = y.shape[1]
    pb = km.broadcast_params(km.SEKernelParams.paper_defaults(), b, kern, dtype=torch.float32, device=dev)
    pieces = {}
    (_, (lp, al)), pieces["forward_program"] = wall_s(lambda: mll._nlml_forward(cfg, x, y, pb))
    kinv, pieces["kinv_unpack_and_cholesky_inverse"] = wall_s(
        lambda: torch.cholesky_inverse(tiling.unpack_lower(lp)[:, :n, :n]))
    alpha = al.reshape(b, -1)[:, :n]
    _, pieces["dense_contraction"] = wall_s(lambda: [mll._nlml_dense_grads(
        kern, km.gather_params(pb, i, kern), x[i], alpha[i], kinv[i]) for i in range(b)])
    del kinv, lp, al
    emit("fleet.batch.train", config=f"GPBatch B = {b}, n = {FLEET_N}, tile {TILE}, matern52", steps=TRAIN_STEPS,
         lr=TRAIN_LR, vjp="custom", launches=launches, problems=rows, params_optimize=p_fleet,
         seconds={"optimize": t_opt, "per_step": t_opt / TRAIN_STEPS, "optimize_hyperparameters_batched": t_mll,
                  "float64_dense_adam_all_problems": t_64, "one_step_pieces": pieces},
         peak_memory_gib=peak / 2**30,
         rule=f"per problem: losses rtol {TRAIN_LOSS_RTOL} / atol {TRAIN_LOSS_ATOL}, params rtol {TRAIN_PARAM_RTOL} "
              "(the train phase's rule)")
    del fleet
    torch.cuda.empty_cache()
    return launches


def phase_fleet_update(xw, yw, xtb, dev):
    """fleet.batch.update: update(512 rows a problem), then forget(512), warm, against a cold rebuild."""
    from repro_torch.core import GPBatch
    from repro_torch.kernels import ops

    n = FLEET_N
    fleet = GPBatch(xw[:, :n], yw[:, :n], tile_size=TILE, device=dev)
    fleet.predict(xtb)
    ops.reset_launch_counts()
    _, t_update = wall_s(lambda: fleet.update(xw[:, n:n + TILE], yw[:, n:n + TILE]))
    warm_after_update = fleet._cache_warm()
    _, t_forget = wall_s(lambda: fleet.forget(TILE))
    warm_after_forget = fleet._cache_warm()
    mean, t_predict = wall_s(lambda: fleet.predict(xtb))
    launches = ops.launch_counts()
    cold, t_cold = wall_s(lambda: GPBatch(xw[:, TILE:n + TILE], yw[:, TILE:n + TILE], tile_size=TILE,
                                          device=dev).predict(xtb))
    err = max_err(mean, cold)
    scale = float(cold.abs().max())
    emit("fleet.batch.update", config=f"GPBatch B = {xw.shape[0]}, window n = {n}, tile {TILE}", step_rows=TILE,
         launches=launches, warm=[warm_after_update, warm_after_forget], warm_vs_cold_mean_err=err,
         tol=FLEET_VS_SINGLE_TOL * max(1.0, scale),
         seconds={"update": t_update, "forget": t_forget, "warm_predict": t_predict, "cold_rebuild_predict": t_cold})
    check(warm_after_update and warm_after_forget, "fleet.batch.update fell back to a refactorization")
    check(launches["carry_update"] > 0 and launches["potrf"] > 0, f"fleet.batch.update: launches {launches}")
    check(err <= FLEET_VS_SINGLE_TOL * max(1.0, scale), f"fleet.batch.update: warm against cold {err}")
    del fleet
    torch.cuda.empty_cache()
    # the widest launch of each kernel in a warm update and forget (the carry's is forget's UCARRY)
    fleet = GPBatch(xw[:, :n], yw[:, :n], tile_size=TILE, device=dev)
    fleet.predict(xtb)
    with widest_launches() as kept:
        fleet.update(xw[:, n:n + TILE], yw[:, n:n + TILE])
        fleet.forget(TILE)
    del fleet
    plain = held_to_plain("fleet.batch.update", kept, dev)
    emit("fleet.batch.update.kernels", widest_launches=plain)
    check("carry_update" in plain, "fleet.batch.update: no carry launch was held to its plain version")
    return launches, plain


def phase_fleet_lowrank(dev):
    """fleet.batch.lowrank: GPBatch(method="lowrank") of B = 8 x n = 32768, each problem against a float64 DTC."""
    from repro_torch.core import GPBatch
    from repro_torch.kernels import ops

    xl, yl, xtl, _ = fleet_data(FLEET_LR_B, FLEET_LR_N, FLEET_LR_NT, SEED)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fleet = GPBatch(xl, yl, tile_size=TILE, method="lowrank", m_inducing=FLEET_LR_M, device=dev)
    (mean, var), t_cold = wall_s(lambda: fleet.predict_with_uncertainty(xtl))
    mean_w, t_warm = wall_s(lambda: fleet.predict(xtl))
    launches = ops.launch_counts()
    nl = fleet.nlml()
    peak = torch.cuda.max_memory_allocated() - base
    u = fleet.lowrank_posterior().u_chunks.reshape(FLEET_LR_B, -1, N_FEATURES)[:, :FLEET_LR_M]
    rows = []
    for i in range(FLEET_LR_B):
        errs, dense, mean_bound, var_bound = lowrank_accuracy(
            {"mean": mean[i], "var": var[i], "mean_warm": mean_w[i]}, xl[i], yl[i], xtl[i], u[i], dev)
        rows.append(dict(problem=i, **errs, mean_bound=mean_bound, var_bound=var_bound, **dense))
        check(errs["mean"] <= mean_bound and errs["mean_warm"] <= mean_bound and errs["var"] <= var_bound,
              f"fleet.batch.lowrank problem {i}: {rows[-1]}")
    emit("fleet.batch.lowrank", config=f"GPBatch B = {FLEET_LR_B}, n = {FLEET_LR_N}, n_test = {FLEET_LR_NT}, "
         f"m_inducing = {FLEET_LR_M}, tile {TILE}", launches=launches, accuracy=rows,
         nlml_finite=bool(torch.isfinite(nl).all()), bound_rule=BOUND_RULE.replace("torch.linalg.cholesky", "DTC"),
         seconds={"cold_predict_with_uncertainty": t_cold, "warm_predict": t_warm},
         problems_per_s={"cold": FLEET_LR_B / t_cold, "warm": FLEET_LR_B / t_warm}, peak_memory_gib=peak / 2**30)
    check(launches["lrgemm"] > 0 and all(launches[k] > 0 for k in MAIN_KERNELS), f"fleet.batch.lowrank: {launches}")
    del fleet, u
    torch.cuda.empty_cache()
    # the widest launch of each kernel of a cold call, LRGEMM's with the per-problem offset index vectors
    with widest_launches() as kept:
        GPBatch(xl, yl, tile_size=TILE, method="lowrank", m_inducing=FLEET_LR_M, device=dev).predict(xtl)
    plain = held_to_plain("fleet.batch.lowrank", kept, dev)
    emit("fleet.batch.lowrank.kernels", widest_launches=plain)
    check("lrgemm" in plain, "fleet.batch.lowrank: no LRGEMM launch was held to its plain version")
    return launches, plain


def ragged_data():
    """fleet.ragged's 32 problems (sizes from fig11's skewed mix, seed SEED) and a shared test block."""
    ns = skewed_sizes(RAGGED_B, RAGGED_LO, RAGGED_HI, np.random.default_rng(SEED))
    data = [make_data(int(n), RAGGED_NT, N_FEATURES, SEED + i) for i, n in enumerate(ns)]
    xs, ys = [d[0] for d in data], [d[1] for d in data]
    shared = data[0][2]
    rng = np.random.default_rng(SEED + 1)
    each = [d[2][: int(k)] for d, k in zip(data, rng.integers(RAGGED_NT // 8, RAGGED_NT + 1, RAGGED_B))]
    return ns, xs, ys, shared, each


def phase_fleet_ragged(dev):
    """fleet.ragged: GPFleet over 32 skewed sizes against single GPs and float64, then a migrating update."""
    from repro_torch.core import GaussianProcess, GPFleet, executor, tiling
    from repro_torch.kernels import ops

    ns, xs, ys, shared, each = ragged_data()
    assign = tiling.bucket_problems(ns, TILE)
    per_bucket = {}
    for cap, idx in assign.items():
        by_op = executor.program_plan(cap, 0, False, None).launches_by_op()
        per_bucket[cap] = {**NO_LAUNCHES, "cov_tiles": by_op["assemble"] + 2, "potrf": by_op["potrf"],
                           "trsm": by_op.get("trsm", 0), "trail": by_op.get(executor.TRAIL, 0)}
    want = {k: sum(p[k] for p in per_bucket.values()) for k in NO_LAUNCHES}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fleet = GPFleet(xs, ys, tile_size=TILE, device=dev)
    (mean, var), t_cold = wall_s(lambda: fleet.predict_with_uncertainty(shared))
    c_cold = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    each_out, t_each = wall_s(lambda: fleet.predict_each(each))
    launches = ops.launch_counts()
    gps = [GaussianProcess(x, y, tile_size=TILE, device=dev) for x, y in zip(xs, ys)]
    singles, t_loop = wall_s(lambda: [gp.predict_with_uncertainty(shared) for gp in gps])
    em, ev = fleet_single_errors(mean, var, singles)
    e_each = max(max_err(m, gp.predict(xt)) for m, gp, xt in zip(each_out, gps, each))
    del gps, singles
    torch.cuda.empty_cache()
    picks = sorted({i for idx in assign.values() for i in (idx[0], idx[-1])})
    acc = fleet_accuracy(picks, xs, ys, [shared] * RAGGED_B, mean, var, dev)
    # ragged arrivals: two problems pushed just past their bucket's capacity, the rest small
    rng = np.random.default_rng(SEED + 2)
    # the others stay inside their bucket (the largest is full at RAGGED_HI)
    arrive = [min(int(k), cap_of(assign, i) * TILE - int(ns[i])) for i, k in enumerate(rng.integers(0, 300, RAGGED_B))]
    movers = [idx[-1] for cap, idx in assign.items() if cap < max(assign)][-2:]
    for i in movers:
        arrive[i] = cap_of(assign, i) * TILE - int(ns[i]) + 100
    x_new, y_new, _, _ = make_data(sum(arrive), 1, N_FEATURES, SEED + 100)  # one series, cut into the arrivals
    cuts = np.cumsum([0] + arrive)
    xa = [x_new[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    ya = [y_new[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    ops.reset_launch_counts()
    _, t_update = wall_s(lambda: fleet.update(xa, ya))
    warm = all(b.state is not None for b in fleet._buckets.values())
    moved = [i for i in range(RAGGED_B) if cap_of(fleet.bucket_assignment(), i) != cap_of(assign, i)]
    after, t_after = wall_s(lambda: fleet.predict(shared))
    c_update = ops.launch_counts()
    cold, t_rebuild = wall_s(lambda: GPFleet(fleet._xs, fleet._ys, tile_size=TILE, device=dev).predict(shared))
    e_update = max_err(after, cold)
    emit("fleet.ragged", config=f"GPFleet B = {RAGGED_B}, sizes log-uniform in [{RAGGED_LO}, {RAGGED_HI}] "
         f"(benchmarks/fig11_ragged_fleet.py::skewed_sizes, seed {SEED}), n_test = {RAGGED_NT} shared, tile {TILE}, "
         "pow2 buckets", sizes=[int(n) for n in ns], buckets={cap: len(idx) for cap, idx in assign.items()},
         launches_cold=c_cold, plan_cold=want, launches_per_bucket_plan=per_bucket,
         vs_single_gps={"mean": em, "var": ev, "predict_each_mean": e_each, "tol": FLEET_VS_SINGLE_TOL},
         accuracy=acc, bound_rule=BOUND_RULE,
         update={"arrivals": arrive, "migrated": moved, "warm": warm, "launches": c_update,
                 "warm_vs_cold_mean_err": e_update, "buckets_after": {c: len(i) for c, i in fleet.bucket_assignment().items()}},
         seconds={"cold_predict_with_uncertainty": t_cold, "predict_each_warm": t_each, "loop_of_single_gps_cold": t_loop,
                  "update": t_update, "warm_predict_after_update": t_after, "cold_rebuild_predict": t_rebuild},
         problems_per_s={"fleet_cold": RAGGED_B / t_cold, "loop_cold": RAGGED_B / t_loop},
         peak_memory_gib=peak / 2**30)
    check(without_vector(c_cold) == without_vector(want) and all(c_cold[k] > 0 for k in VECTOR_KERNELS),
          f"fleet.ragged: launches {c_cold} differ from the buckets' plans {want}")
    check(max(em, ev, e_each) <= FLEET_VS_SINGLE_TOL, f"fleet.ragged against single GPs: {em}, {ev}, {e_each}")
    check(len(moved) >= 2 and warm, f"fleet.ragged update: migrated {moved}, warm {warm}")
    check(e_update <= FLEET_VS_SINGLE_TOL, f"fleet.ragged update: warm against cold {e_update}")
    del fleet
    torch.cuda.empty_cache()
    total = {k: launches[k] + c_update[k] for k in launches}
    # the widest launch of each kernel of a cold call (the largest bucket's) and of the migrating update
    fleet = GPFleet(xs, ys, tile_size=TILE, device=dev)
    with widest_launches() as kept:
        fleet.predict_with_uncertainty(shared)
    plain = {"cold": held_to_plain("fleet.ragged", kept, dev)}
    with widest_launches() as kept:
        fleet.update(xa, ya)
    del fleet
    plain["update"] = held_to_plain("fleet.ragged.update", kept, dev)
    emit("fleet.ragged.kernels", widest_launches=plain)
    return total, {k: max(r[k]["max_abs_err"] for r in plain.values() if k in r)
                   for k in set(plain["cold"]) | set(plain["update"])}


def cap_of(assign, i):
    return next(cap for cap, idx in assign.items() if i in idx)


def phase_fleet_timing(xb, yb, xtb, dev):
    """Cold GPBatch and GPFleet calls beside their loops of single GPs, in turns; then their profiles."""
    from repro_torch.core import GaussianProcess, GPBatch, GPFleet

    b = xb.shape[0]
    times = {"batch_cold": [], "batch_loop_cold": [], "ragged_cold": [], "ragged_loop_cold": []}
    for order in ("fleet", "loop", "loop", "fleet"):
        if order == "fleet":
            times["batch_cold"].append(wall_s(lambda: GPBatch(xb, yb, tile_size=TILE, device=dev)
                                              .predict_with_uncertainty(xtb))[1])
        else:
            times["batch_loop_cold"].append(wall_s(lambda: [
                GaussianProcess(xb[i], yb[i], tile_size=TILE, device=dev).predict_with_uncertainty(xtb[i])
                for i in range(b)])[1])
    ns, xs, ys, shared, _ = ragged_data()
    for order in ("fleet", "loop", "loop", "fleet"):
        if order == "fleet":
            times["ragged_cold"].append(wall_s(lambda: GPFleet(xs, ys, tile_size=TILE, device=dev)
                                               .predict_with_uncertainty(shared))[1])
        else:
            times["ragged_loop_cold"].append(wall_s(lambda: [
                GaussianProcess(x, y, tile_size=TILE, device=dev).predict_with_uncertainty(shared)
                for x, y in zip(xs, ys)])[1])
    emit("timing.fleet", seconds=times, order="fleet, loop, loop, fleet (batch, then ragged)",
         problems_per_s={k: [(b if k.startswith("batch") else RAGGED_B) / t for t in v] for k, v in times.items()},
         note="host clock around calls ending in torch.cuda.synchronize(); cold calls build the fleet's factors")
    torch.cuda.empty_cache()
    batch = GPBatch(xb, yb, tile_size=TILE, device=dev)
    profile_call("profile.fleet", f"GPBatch.predict_with_uncertainty (cold), B = {b} x n = {FLEET_N}",
                 lambda: batch.predict_with_uncertainty(xtb))
    del batch
    torch.cuda.empty_cache()
    ragged = GPFleet(xs, ys, tile_size=TILE, device=dev)
    profile_call("profile.fleet_ragged", f"GPFleet.predict_with_uncertainty (cold), B = {RAGGED_B} skewed sizes",
                 lambda: ragged.predict_with_uncertainty(shared))
    del ragged
    torch.cuda.empty_cache()


# fleet.ragged.lowrank: fig11's skewed mix on the Nystrom tier, B = 16 sizes log-uniform in [512, 65536]
RLR_B, RLR_LO, RLR_HI, RLR_NT, RLR_M = 16, 512, 65536, 1024, 1024
# a warm low-rank update against a cold rebuild: float32 inner systems summed in another order
RLR_UPDATE_TOL = 3e-3
# serve.fleet: 6 waves of 64 predictions (n̂ in [1, 256], a quarter with variances) and 8 observations (b in [1, 512])
SERVE_WAVES, SERVE_PREDICTS, SERVE_OBSERVES, SERVE_NT_MAX, SERVE_B_MAX = 6, 64, 8, 256, 512


def ragged_lowrank_data():
    """fleet.ragged.lowrank's 16 problems (sizes from fig11's skewed mix, seed SEED), a shared test block,
    and a pinned inducing set (a strided subset of the largest problem's rows) for the update."""
    ns = skewed_sizes(RLR_B, RLR_LO, RLR_HI, np.random.default_rng(SEED))
    data = [make_data(int(n), RLR_NT, N_FEATURES, SEED + 200 + i) for i, n in enumerate(ns)]
    xs, ys = [d[0] for d in data], [d[1] for d in data]
    u = xs[-1][:: len(xs[-1]) // RLR_M][:RLR_M].copy()
    return ns, xs, ys, data[0][2], u


def bucket_lowrank_launches(assign, m_inducing, kind):
    """Launches of a low-rank fleet's buckets, from the plans: ``lowrank_launches`` once a bucket."""
    per = lowrank_launches(m_inducing)[kind]
    return {k: v * len(assign) for k, v in per.items()}


def phase_fleet_ragged_lowrank(dev):
    """fleet.ragged.lowrank: GPFleet(method="lowrank") of 16 skewed sizes against single GPs and a float64 DTC,
    then a migrating update on a pinned inducing set; fleet.ragged.lowrank.kernels: the widest launches."""
    from repro_torch.core import GaussianProcess, GPFleet, executor, tiling
    from repro_torch.kernels import ops

    ns, xs, ys, shared, u_pin = ragged_lowrank_data()
    assign = tiling.bucket_problems(ns, TILE)
    kw = dict(tile_size=TILE, method="lowrank", m_inducing=RLR_M, strategy="subset", jitter=1e-4, device=dev)
    want = bucket_lowrank_launches(assign, RLR_M, "cold_predict_with_uncertainty")
    want_warm = bucket_lowrank_launches(assign, RLR_M, "warm_predict_with_uncertainty")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fleet = GPFleet(xs, ys, **kw)
    (mean, var), t_cold = wall_s(lambda: fleet.predict_with_uncertainty(shared))
    c_cold = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    ops.reset_launch_counts()
    (mean_w, var_w), t_warm = wall_s(lambda: fleet.predict_with_uncertainty(shared))
    c_warm = ops.launch_counts()
    nl = fleet.nlml()
    launches = {k: c_cold[k] + c_warm[k] for k in c_cold}
    gps = [GaussianProcess(x, y, **kw) for x, y in zip(xs, ys)]
    singles, t_loop = wall_s(lambda: [gp.predict_with_uncertainty(shared) for gp in gps])
    _, t_loop_warm = wall_s(lambda: [gp.predict_with_uncertainty(shared) for gp in gps])
    em, ev = fleet_single_errors(mean, var, singles)
    del gps, singles
    torch.cuda.empty_cache()
    rows = []
    for cap, idx in assign.items():
        st = fleet._buckets[cap].state
        mvs = st.mu_valid.tolist()
        for pos, i in enumerate(idx):
            u = st.u_chunks[pos].reshape(-1, N_FEATURES)[: mvs[pos]]
            errs, dense, mean_bound, var_bound = lowrank_accuracy(
                {"mean": mean[i], "var": var[i], "mean_warm": mean_w[i], "var_warm": var_w[i]},
                xs[i], ys[i], shared, u, dev)
            rows.append(dict(problem=i, n=int(ns[i]), bucket=cap, mu_valid=mvs[pos], **errs, mean_bound=mean_bound,
                             var_bound=var_bound, **dense))
            check(max(errs["mean"], errs["mean_warm"]) <= mean_bound and max(errs["var"], errs["var_warm"]) <= var_bound,
                  f"fleet.ragged.lowrank problem {i} (n = {ns[i]}) outside the dense-DTC rule: {rows[-1]}")
    del fleet
    torch.cuda.empty_cache()
    # the update: a pinned, shared inducing set; two problems pushed past their bucket's capacity
    rng = np.random.default_rng(SEED + 3)
    arrive = [min(int(k), cap_of(assign, i) * TILE - int(ns[i])) for i, k in enumerate(rng.integers(0, 300, RLR_B))]
    movers = [idx[-1] for cap, idx in assign.items() if cap < max(assign)][-2:]
    for i in movers:
        arrive[i] = cap_of(assign, i) * TILE - int(ns[i]) + 100
    x_new, y_new, _, _ = make_data(sum(arrive), 1, N_FEATURES, SEED + 300)
    cuts = np.cumsum([0] + arrive)
    xa = [x_new[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    ya = [y_new[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    pinned = GPFleet(xs, ys, inducing=u_pin, **kw)
    pinned.predict(shared)
    ops.reset_launch_counts()
    _, t_update = wall_s(lambda: pinned.update(xa, ya))
    c_update = ops.launch_counts()
    after_assign = pinned.bucket_assignment()
    warm = all(b.state is not None for b in pinned._buckets.values())
    moved = [i for i in range(RLR_B) if cap_of(after_assign, i) != cap_of(assign, i)]
    absorbing = sum(1 for idx in after_assign.values() if any(arrive[i] for i in idx))
    chol = executor.cholesky_plan(RLR_M // TILE).launches_by_op()
    want_update = {**NO_LAUNCHES, "cov_tiles": absorbing, "lrgemm": 2 * absorbing, "potrf": absorbing * chol["potrf"],
                   "trsm": absorbing * chol.get("trsm", 0),
                   "trail": absorbing * (chol.get("syrk", 0) + chol.get("gemm", 0))}
    after, t_after = wall_s(lambda: pinned.predict(shared))
    cold, t_rebuild = wall_s(lambda: GPFleet(pinned._xs, pinned._ys, inducing=u_pin, **kw).predict(shared))
    e_update = max_err(after, cold)
    tol_update = RLR_UPDATE_TOL * max(1.0, float(cold.abs().max()))
    launches = {k: launches[k] + c_update[k] for k in launches}
    emit("fleet.ragged.lowrank", config=f"GPFleet(method='lowrank') B = {RLR_B}, sizes log-uniform in [{RLR_LO}, "
         f"{RLR_HI}] (benchmarks/fig11_ragged_fleet.py::skewed_sizes, seed {SEED}), n_test = {RLR_NT} shared, "
         f"m_inducing = {RLR_M}, subset, jitter 1e-4, tile {TILE}, pow2 buckets", sizes=[int(n) for n in ns],
         buckets={cap: len(idx) for cap, idx in assign.items()}, launches_cold=c_cold, plan_cold=want,
         launches_warm=c_warm, plan_warm=want_warm, vs_single_gps={"mean": em, "var": ev},
         accuracy=rows, bound_rule=BOUND_RULE.replace("torch.linalg.cholesky", "DTC"),
         nlml_finite=bool(torch.isfinite(nl).all()),
         update={"arrivals": arrive, "migrated": moved, "warm": warm, "launches": c_update, "plan": want_update,
                 "warm_vs_cold_mean_err": e_update, "tol": tol_update,
                 "buckets_after": {c: len(i) for c, i in after_assign.items()}},
         seconds={"cold_predict_with_uncertainty": t_cold, "warm_predict_with_uncertainty": t_warm,
                  "loop_of_single_gps_cold": t_loop, "loop_of_single_gps_warm": t_loop_warm, "update": t_update,
                  "warm_predict_after_update": t_after, "cold_rebuild_predict": t_rebuild},
         problems_per_s={"fleet_cold": RLR_B / t_cold, "loop_cold": RLR_B / t_loop, "fleet_warm": RLR_B / t_warm,
                         "loop_warm": RLR_B / t_loop_warm},
         peak_memory_gib=peak / 2**30)
    check(without_vector(c_cold) == without_vector(want) and without_vector(c_warm) == without_vector(want_warm)
          and all(c_cold[k] > 0 for k in VECTOR_KERNELS),
          f"fleet.ragged.lowrank: launches {c_cold} / {c_warm} differ from "
          f"the buckets' plans {want} / {want_warm}")
    check(len(moved) >= 2 and warm, f"fleet.ragged.lowrank update: migrated {moved}, warm {warm}")
    check(without_vector(c_update) == without_vector(want_update),
          f"fleet.ragged.lowrank update: launches {c_update}, want chol(B) alone {want_update}")
    check(e_update <= tol_update, f"fleet.ragged.lowrank update: warm against cold {e_update} > {tol_update}")
    del pinned, after, cold
    torch.cuda.empty_cache()
    # the widest launch of each kernel of a cold call ((B,) mu_valid / n_valid frontiers) and of the update (counts)
    with widest_launches() as kept:
        GPFleet(xs, ys, **kw).predict_with_uncertainty(shared)
    plain = {"cold": held_to_plain("fleet.ragged.lowrank", kept, dev)}
    fleet = GPFleet(xs, ys, inducing=u_pin, **kw)
    fleet.predict(shared)
    with widest_launches() as kept:
        fleet.update(xa, ya)
    del fleet
    plain["update"] = held_to_plain("fleet.ragged.lowrank.update", kept, dev)
    emit("fleet.ragged.lowrank.kernels", widest_launches=plain)
    check({"cov_tiles", "lrgemm", "potrf", "trsm", "trail"} <= set(plain["cold"]),
          f"fleet.ragged.lowrank: a kernel of the path was not held to its plain version: {sorted(plain['cold'])}")
    torch.cuda.empty_cache()
    return launches, {k: max(r[k]["max_abs_err"] for r in plain.values() if k in r)
                      for k in set(plain["cold"]) | set(plain["update"])}


def serve_traffic(b, seed, drift: bool):
    """6 waves of seeded requests: (predicts [(problem, x, uncertainty)], observes [(problem, x, y)]) a wave.

    With ``drift`` the observed targets climb by 0.5 a wave: the data drifts under the hyperparameters.
    """
    rng = np.random.default_rng(seed)
    waves = []
    for w in range(SERVE_WAVES):
        nts = rng.integers(1, SERVE_NT_MAX + 1, SERVE_PREDICTS)
        bs = rng.integers(1, SERVE_B_MAX + 1, SERVE_OBSERVES)
        xt, _, _, _ = make_data(int(nts.sum()), 1, N_FEATURES, seed + 10 * w + 1)
        xo, yo, _, _ = make_data(int(bs.sum()), 1, N_FEATURES, seed + 10 * w + 2)
        cut_t, cut_o = np.cumsum([0, *nts]), np.cumsum([0, *bs])
        predicts = [(int(p), xt[a:c], bool(q)) for p, a, c, q in
                    zip(rng.integers(0, b, SERVE_PREDICTS), cut_t[:-1], cut_t[1:], rng.random(SERVE_PREDICTS) < 0.25)]
        observes = [(int(p), xo[a:c], yo[a:c] + (0.5 * w if drift else 0.0)) for p, a, c in
                    zip(rng.integers(0, b, SERVE_OBSERVES), cut_o[:-1], cut_o[1:])]
        waves.append((predicts, observes))
    return waves


def serve_run(name, fleet, waves, dev, drift_steps=None):
    """Drive a ContinuousBatcher over ``fleet`` through ``waves``; hold every result bitwise to a synchronous
    ``predict_each`` on the wave's snapshot.  Per wave: host seconds of ``step``, device ms of its launches
    (CUDA events around the call), and the host's wait for them after ``step`` returned."""
    import repro_torch.obs as obs
    from repro_torch.serve import ContinuousBatcher

    d = N_FEATURES
    expect = {}

    def synchronous(wave):
        """What the batcher dispatched this wave, by a synchronous predict_each on the same snapshot."""
        predicts, _ = waves[wave]
        tests = [[] for _ in range(fleet.batch_size)]
        for p, x, _ in predicts:
            tests[p].append(x)
        tests = [np.concatenate(t) if t else np.zeros((0, d), np.float32) for t in tests]
        want_unc = any(q for _, _, q in predicts)
        out = fleet.predict_each(tests, full_cov=want_unc)
        expect[wave] = [(o[0], torch.diagonal(o[1])) if want_unc else (o, None) for o in out]

    state = {"wave": 0}

    def reoptimize():
        synchronous(state["wave"])  # the wave's snapshot, before the new hyperparameters
        fleet.optimize(steps=drift_steps)

    monitor = obs.DriftMonitor(alpha=0.5, threshold=0.02, warmup=1, cooldown=10 ** 6) if drift_steps else None
    srv = ContinuousBatcher(fleet, drift_monitor=monitor, reoptimize=reoptimize if drift_steps else None)
    per_wave, rids = [], []
    for w, (predicts, observes) in enumerate(waves):
        state["wave"] = w
        for p, x, y in observes:
            srv.submit_observe(p, x, y)
        rids.append([(srv.submit_predict(p, x, uncertainty=q), p, q) for p, x, q in predicts])
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        st = srv.step()
        ev1.record()
        t_ret = time.perf_counter()
        ev1.synchronize()
        wait = time.perf_counter() - t_ret
        srv.flush()
        if w not in expect:
            synchronous(w)
        torch.cuda.synchronize()
        per_wave.append(dict(wave=w, host_s=st.duration_s, device_ms=ev0.elapsed_time(ev1), wait_after_return_s=wait,
                             migrations=st.migrations, points_absorbed=st.points_absorbed,
                             reoptimized=st.reoptimized, buckets=list(st.buckets)))
    # every request's rows against the synchronous call's, bitwise
    mismatched = 0
    for w, wave_rids in enumerate(rids):
        off = {}
        for rid, p, q in wave_rids:
            got = srv.result(rid)
            k = (got[0] if q else got).shape[0]
            o = off.get(p, 0)
            mean, var = expect[w][p]
            want_mean = mean[o:o + k].cpu()
            ok = torch.equal(got[0] if q else got, want_mean)
            if q:
                ok = ok and torch.equal(got[1], var[o:o + k].cpu())
            mismatched += not ok
            off[p] = o + k
    s = srv.summary()
    service_s = sum(r["host_s"] + r["wait_after_return_s"] for r in per_wave)
    return srv, dict(fleet=name, waves=per_wave, waves_per_s=len(waves) / service_s,
                     requests_per_s=s["requests"] / service_s, latency_ms={"p50": s["p50_ms"], "p99": s["p99_ms"],
                                                                           "max": s["max_ms"]},
                     reoptimizations=s["reoptimizations"], requests=s["requests"], mismatched_results=mismatched)


def phase_serve(x_train, y_train, x_test, dev):
    """serve.fleet: a ContinuousBatcher over fleet.ragged's exact GPFleet, then over fleet.ragged.lowrank's
    fleet (pinned inducing set) with one drift-triggered re-optimize; then the cost of telemetry at gp_16k."""
    import repro_torch.obs as obs
    from repro_torch.core import GaussianProcess, GPFleet

    out = {}
    _, xs, ys, shared, _ = ragged_data()
    fleet = GPFleet(xs, ys, tile_size=TILE, device=dev)
    fleet.predict(shared)  # a serving fleet is warm
    srv, out["exact"] = serve_run("exact", fleet, serve_traffic(RAGGED_B, SEED + 400, drift=False), dev)
    cold = GPFleet(fleet._xs, fleet._ys, tile_size=TILE, device=dev).predict(shared)
    out["exact"]["after_vs_cold_mean_err"] = max_err(fleet.predict(shared), cold)
    check(out["exact"]["after_vs_cold_mean_err"] <= FLEET_VS_SINGLE_TOL, f"serve.fleet exact after the waves: {out['exact']}")
    del srv, fleet, cold
    torch.cuda.empty_cache()
    _, xs, ys, shared, u_pin = ragged_lowrank_data()
    kw = dict(tile_size=TILE, method="lowrank", m_inducing=RLR_M, inducing=u_pin, device=dev)
    fleet = GPFleet(xs, ys, **kw)
    fleet.predict(shared)
    srv, out["lowrank"] = serve_run("lowrank", fleet, serve_traffic(RLR_B, SEED + 500, drift=True), dev, drift_steps=2)
    after = fleet.predict(shared)
    cold = GPFleet(fleet._xs, fleet._ys, params=fleet.params, **kw).predict(shared)
    out["lowrank"]["after_vs_cold_mean_err"] = max_err(after, cold)
    out["lowrank"]["after_vs_cold_tol"] = RLR_UPDATE_TOL * max(1.0, float(cold.abs().max()))
    del srv, fleet, cold, after
    torch.cuda.empty_cache()
    # telemetry: gp_16k's cold predict with obs off, on, off; bitwise equal outputs
    times, outs = {"off": [], "on": []}, {}
    GaussianProcess(x_train, y_train, tile_size=TILE, device=dev).predict(x_test)  # warm the allocator
    for mode in ("off", "on", "on", "off"):
        (obs.enable if mode == "on" else obs.disable)()
        obs.reset()
        res, t = wall_s(lambda: GaussianProcess(x_train, y_train, tile_size=TILE, device=dev).predict(x_test))
        times[mode].append(t)
        outs.setdefault(mode, res)
        if mode == "on":
            recorded = len(obs.snapshot()["events"])
    obs.disable()
    obs.reset()
    telemetry = {"seconds": times, "overhead_ms": (np.mean(times["on"]) - np.mean(times["off"])) * 1e3,
                 "bitwise_equal": bool(torch.equal(outs["on"], outs["off"])), "events_recorded_when_on": recorded}
    emit("serve.fleet", config=f"ContinuousBatcher: {SERVE_WAVES} waves of {SERVE_PREDICTS} predictions (n̂ uniform in "
         f"[1, {SERVE_NT_MAX}], a quarter with variances) and {SERVE_OBSERVES} observations (b uniform in "
         f"[1, {SERVE_B_MAX}]), over fleet.ragged's exact fleet and fleet.ragged.lowrank's (pinned inducing set, "
         "drifting targets, one re-optimize of 2 steps)", exact=out["exact"], lowrank=out["lowrank"], telemetry=telemetry,
         note="service time of a wave = host seconds of step + the wait for its launches after step returned")
    for name, r in out.items():
        check(r["mismatched_results"] == 0, f"serve.fleet {name}: {r['mismatched_results']} results differ from a "
              "synchronous predict_each on the same snapshot")
    check(out["lowrank"]["reoptimizations"] == 1.0, f"serve.fleet lowrank: {out['lowrank']['reoptimizations']} re-optimizes")
    check(out["lowrank"]["after_vs_cold_mean_err"] <= out["lowrank"]["after_vs_cold_tol"],
          f"serve.fleet lowrank after the waves: {out['lowrank']}")
    check(telemetry["bitwise_equal"] and telemetry["events_recorded_when_on"] > 0,
          f"serve.fleet telemetry: {telemetry}")


# ---------------------------------------------------------------------------
# Multi-device (step 10a): P x Q ranks sharing the card over gloo
# ---------------------------------------------------------------------------
#
# The smoke test needs one card, and NCCL refuses two ranks on one GPU,
# so these phases spawn one process a rank on cuda:(rank % device_count)
# over gloo, which stages CUDA tensors through the host.  That proves the
# algorithm, each rank's kernels and the collectives on the card; it does
# not measure multi-GPU scaling.  The parent builds the kernels first, so
# the ranks only load them.  A rank that raises or fails a check makes the
# spawn raise in the parent, and the script exits non-zero.

DIST_GRID = (2, 2)            # ("data", "model"): P = Q = 2
DIST_BF16_RTOL = 0.02         # the reference's mixed-precision rule (tests/test_distributed_gp.py)
SHARDED_FLEET_TOL = 1e-5      # the reference's sharded-against-unsharded rule (tests/test_sharded_fleet.py)
# the rule on the card: the reference's, since a fleet's matvecs and diagonal-tile solves go through the
# batch-invariant tile_gemv / tile_trsv kernel (cuBLAS's batched GEMV and triangular solve, which pick another
# algorithm at another problem count, put sharded fleets 6.1e-5 ... 1.83e-4 off; scripts/batch_invariance.py)
SHARDED_FLEET_CARD_TOL = SHARDED_FLEET_TOL
DIST_COUNTS: dict = {}  # dist.predict's rank 0: collectives by op and launches, held against the dry-run (launch.dist)
MULTI_BUDGET_S = 60.0         # the multi-device phases' share of the script's wall time that was planned
SHARDED_WAVES = 2


def _rank_entry(rank, world, tmp, job, args, shared_q):
    """One rank: its card, the default group over gloo on a FileStore, the job; its result saved for the parent.

    CUDA tensors of the parent come through ``shared_q`` (CUDA IPC), not as spawn arguments, which a process
    keeps to its end: the rank drops them when the job returns, so that the parent can free them.
    """
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / "store"), world), rank=rank,
                            world_size=world)
    try:
        shared = [shared_q.get()] if shared_q is not None else []
        result = RANK_JOBS[job](rank, world, *shared, *args)
        del shared
        torch.cuda.synchronize()
        torch.save(result, Path(tmp) / f"rank{rank}.pt")
        dist.barrier()
    except BaseException:
        # the parent's spawn reports one rank's error, often a peer's lost connection: show each rank's own
        print(f"rank {rank} of {world} failed:", file=sys.stderr, flush=True)
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` spawned ranks running ``job``; ``join()`` returns their results by rank (it raises if one fails).

    ``shared``, CUDA tensors of this process, goes to every rank by CUDA IPC as the job's first argument.
    """

    def __init__(self, job: str, world: int, *args, shared=None):
        import tempfile

        import torch.multiprocessing as mp

        self.world, self.shared, self.t0 = world, shared, time.perf_counter()
        shared_q = None
        if shared is not None:
            shared_q = mp.get_context("spawn").SimpleQueue()
            for _ in range(world):
                shared_q.put(shared)
        self._queue = shared_q  # held until the join: a rank that starts late still opens its semaphore
        self._tmp = tempfile.TemporaryDirectory()
        self._ranks = mp.start_processes(_rank_entry, args=(world, self._tmp.name, job, args, shared_q),
                                         nprocs=world, join=False, start_method="spawn")

    def join(self):
        """(the results by rank, the world's wall seconds from its spawn)."""
        import multiprocessing

        try:
            while not self._ranks.join():
                pass
            out = [torch.load(Path(self._tmp.name) / f"rank{r}.pt", weights_only=False) for r in range(self.world)]
        finally:
            self._tmp.cleanup()
        seconds = time.perf_counter() - self.t0
        del self._ranks
        multiprocessing.active_children()
        if self.shared is not None:
            self.shared = self._queue = None
            torch.cuda.ipc_collect()  # the ranks have dropped the shared tensors: free this process's side
        return out, seconds


def _here():
    return torch.device("cuda", torch.cuda.current_device())


def timed_between_barriers(fn):
    """(result, seconds on this rank's clock from one barrier to the next, the device work included)."""
    import torch.distributed as dist

    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dist.barrier()
    return out, time.perf_counter() - t0


def probe_job(rank, world):
    """Both collectives of repro_torch.dist.collectives on CUDA tensors over gloo, float32 and bf16."""
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.mesh import make_fleet_mesh

    mesh = make_fleet_mesh()
    x = torch.full((3,), float(rank + 1), device=_here())
    s, g = coll.psum(x, mesh, ("data",)), coll.gather_axes(x, mesh, ("data",))
    gb = coll.gather_axes(x.to(torch.bfloat16), mesh, ("data",))
    return dict(mesh_device=mesh.device_type, device=str(s.device), psum=s.tolist(), gather=g.tolist(),
                gather_bf16=gb.float().tolist())


def report_probe(ranks):
    want = [[float(r + 1)] * 3 for r in range(len(ranks))]
    total = [float(sum(range(1, len(ranks) + 1)))] * 3
    ok = all(r["psum"] == total and r["gather"] == want and r["gather_bf16"] == want
             and r["device"].startswith("cuda") and r["mesh_device"] == "cuda" for r in ranks)
    emit("dist.probe", backend="gloo", ranks=ranks,
         note="all_reduce and the list form of all_gather on CUDA tensors, float32 and bf16, every rank on one card")
    check(ok, f"dist.probe: gloo collectives on CUDA tensors gave {ranks}")


def _dist_mesh():
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(DIST_GRID, ("data", "model"))


def _owned_tiles(dense, mesh, m):
    """This rank's (Mp, Mq, m, m) block-cyclic tiles of a dense (n, n) matrix, as a view."""
    from repro_torch.dist import collectives as coll

    p, q = DIST_GRID
    mp, mq = dense.shape[0] // (p * m), dense.shape[1] // (q * m)
    pr, pc = coll.linear_index(mesh, ("data",)), coll.linear_index(mesh, ("model",))
    return dense.view(mp, p, m, mq, q, m)[:, pr, :, :, pc, :].permute(0, 2, 1, 3)


def _factor_error(local, l64, mesh):
    """max |L - L64| over this rank's lower tiles (the diagonal tiles' lower triangles), and max |L| there."""
    from repro_torch.dist import collectives as coll

    p, q = DIST_GRID
    mp, mq, m, _ = local.shape
    pr, pc = coll.linear_index(mesh, ("data",)), coll.linear_index(mesh, ("model",))
    ref = _owned_tiles(l64, mesh, m)
    glob_k = torch.arange(mq, device=local.device) * q + pc
    err = big = 0.0
    for a in range(mp):
        gi = a * p + pr
        tile = local[a].double()                                     # (Mq, m, m)
        want = ref[a]
        keep = (glob_k < gi)[:, None, None] | ((glob_k == gi)[:, None, None]
                                              & torch.ones(m, m, dtype=torch.bool, device=local.device).tril())
        err = max(err, float(((tile - want).abs() * keep).max()))
        big = max(big, float((tile.abs() * keep).max()))
    return err, big


def cholesky_job(rank, world, x, l64, k_spd, l64_spd):
    """dist.cholesky: this rank's block of the MSD covariance, factored once (``unroll`` changes nothing in eager
    torch: the CPU tests hold both values), then the bf16 update on the reference's well-conditioned test matrix
    A A^T + n I (on the MSD covariance the bf16 update is not finite, as the reference's own at n = 1024)."""
    import torch.distributed as dist

    from repro_torch.configs.gp_msd import GP_DIST_32K
    from repro_torch.core import distributed as dgp
    from repro_torch.core import tiling
    from repro_torch.core.kernels_math import SEKernelParams
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import ops

    mesh = _dist_mesh()
    m, n = GP_DIST_32K.tile_size, GP_DIST_32K.n_train
    xc = tiling.pad_features(torch.from_numpy(x).to(_here()), m)
    msd_local = dgp.local_covariance(mesh, xc, SEKernelParams.paper_defaults(), n)
    spd_local = _owned_tiles(k_spd, mesh, m).contiguous()
    rows = {}
    for name, local, ref, kw in (("float32", msd_local, l64, {}),
                                 ("bf16", spd_local, l64_spd, {"update_dtype": torch.bfloat16})):
        fn = dgp.distributed_cholesky_fn(mesh, m_tiles=n // m, **kw)
        ops.reset_launch_counts()
        coll.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        factor, seconds = timed_between_barriers(lambda: fn(local))
        err, big = _factor_error(factor, ref, mesh)
        rows[name] = dict(seconds=seconds, collective_host_s=coll.STATS["seconds"], collectives=coll.STATS["calls"],
                          collective_bytes_sent=coll.STATS["bytes"], launches=ops.launch_counts(), max_abs_err=err,
                          max_abs_factor=big, finite=bool(torch.isfinite(factor).all()),
                          peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        del factor
        dist.barrier()
    return dict(grid=[coll.linear_index(mesh, ("data",)), coll.linear_index(mesh, ("model",))], rows=rows)


def predict_job(rank, world, x, y, xt):
    """dist.predict: the distributed GP prediction with variances, timed and counted; then a second run, neither
    timed nor counted, in which rank 0 keeps each kernel's widest launch."""
    import torch.distributed as dist

    from repro_torch.configs.gp_msd import GP_DIST_32K
    from repro_torch.core import distributed as dgp
    from repro_torch.core import tiling
    from repro_torch.core.kernels_math import SEKernelParams
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis

    mesh = _dist_mesh()
    m, n, nt = GP_DIST_32K.tile_size, GP_DIST_32K.n_train, GP_DIST_32K.n_test
    dev = _here()
    params = SEKernelParams.paper_defaults()
    chunks = (tiling.pad_features(torch.from_numpy(x).to(dev), m), tiling.pad_vector(torch.from_numpy(y).to(dev), m),
              tiling.pad_features(torch.from_numpy(xt).to(dev), m))
    # warm the libraries, cuBLAS and the groups on 16 tiles before the timed call
    small = dgp.distributed_gp_predict_fn(mesh, m_tiles=16, tile_size=m, n_valid=16 * m, n_test_valid=4 * m,
                                          params=params)
    small(chunks[0][:16], chunks[1][:16], chunks[2][:4])
    fn = dgp.distributed_gp_predict_fn(mesh, m_tiles=n // m, tile_size=m, n_valid=n, n_test_valid=nt, params=params)
    ops.reset_launch_counts()
    coll.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with coll.recording() as calls:
        (mean, var), seconds = timed_between_barriers(lambda: fn(*chunks))
    out = dict(seconds=seconds, collective_host_s=coll.STATS["seconds"], collectives=coll.STATS["calls"],
               collectives_by_op=analysis.collective_stats(calls).as_record(),
               collective_bytes_sent=coll.STATS["bytes"], launches=ops.launch_counts(),
               peak_memory_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               grid=[coll.linear_index(mesh, ("data",)), coll.linear_index(mesh, ("model",))])
    with widest_launches() if rank == 0 else contextlib.nullcontext({}) as kept:
        fn(*chunks)
    # every rank's cached blocks go back to the card before rank 0 holds the kept launches to their plain versions
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        out["mean"], out["var"] = mean.reshape(-1)[:nt].cpu(), var.reshape(-1)[:nt].cpu()
        out["plain"] = held_to_plain("dist.predict", kept, dev)
    else:
        out["digest"] = [float(mean.double().sum()), float(var.double().sum())]
    return out


def dense_factor(x, dev):
    """(float64 factor of the SE covariance at the paper's defaults, max |L32 - L64| of the dense float32 one)."""
    from repro_torch.core import kernels_math as km

    p = km.SEKernelParams.paper_defaults()
    k32 = km.assemble_covariance(torch.from_numpy(x).to(dev), p, dtype=None)
    l64 = torch.linalg.cholesky(k32.double())
    l32 = torch.linalg.cholesky(k32)
    del k32
    err32 = float((l32.double() - l64).abs().max())
    del l32
    torch.cuda.empty_cache()
    return l64, err32


def spd_factor(n, dev):
    """The reference's bf16 test matrix at n: K = A A^T + n I (A standard normal, seed SEED, float32) and the
    float64 factor of it (tests/test_distributed_gp.py::test_mixed_precision_distributed_cholesky)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(n, n, generator=g, device=dev)
    k = a @ a.T
    del a
    k.diagonal().add_(n)
    l64 = torch.linalg.cholesky(k.double())
    return k, l64


def msd_data():
    """data.msd: gp_dist_32k's train and test sets from repro_torch.data.msd, with the z-score checks."""
    from repro_torch.configs.gp_msd import GP_DIST_32K as cfg
    from repro_torch.data import msd

    (x, y, xt, yt), t_data = wall_s(lambda: msd.make_dataset(cfg.n_train, cfg.n_test, seed=SEED))
    z = dict(y_train_mean=float(y.mean()), y_train_std=float(y.std()), x_train_std=float(x.std()),
             x_expected_std=float(1 / np.sqrt(2 * msd.MSDConfig().n_regressors)))
    finite = all(np.isfinite(a).all() for a in (x, y, xt, yt))
    emit("data.msd", config=f"{cfg.name} (src/repro/configs/gp_msd.py:18), MSDConfig() defaults, seed {SEED}",
         seconds=t_data, shapes=[list(a.shape) for a in (x, y, xt, yt)], dtype=str(x.dtype), zscore=z, finite=finite,
         note="repro_torch.data.msd.make_dataset: the RK4 on Python floats, in the reference's operation order")
    check(finite and x.shape == (cfg.n_train, 16) and xt.shape == (cfg.n_test, 16), "data.msd: shapes or values")
    check(abs(z["y_train_mean"]) < 0.05 and abs(z["y_train_std"] - 1) < 0.05
          and abs(z["x_train_std"] / z["x_expected_std"] - 1) < 0.05, f"data.msd: not z-scored: {z}")
    return x, y, xt, yt


def report_cholesky(ranks, err32, scale):
    """dist.cholesky: the float32 factors against PERF.md §2's rule, the bf16 update on A A^T + n I against the
    reference's rule; the bf16 update on the MSD covariance is reported, not held (see its note)."""
    from repro_torch.configs.gp_msd import GP_DIST_32K as cfg
    from repro_torch.core import distributed as dgp

    p, q = DIST_GRID
    m_tiles = cfg.n_train // cfg.tile_size
    want = [dgp.schedule_launches(m_tiles, p, q, pr, pc) for pr in range(p) for pc in range(q)]
    bound = 2 * err32 + 1e-4 * scale
    rows = {}
    for name in ("float32", "bf16"):
        per = [r["rows"][name] for r in ranks]
        err = max(r["max_abs_err"] for r in per)
        rows[name] = dict(seconds_rank0=per[0]["seconds"], max_abs_err=err, finite=all(r["finite"] for r in per),
                          rel_err=err / max(r["max_abs_factor"] for r in per),
                          collective_host_s=[r["collective_host_s"] for r in per],
                          collectives=[r["collectives"] for r in per],
                          collective_mib_sent=[r["collective_bytes_sent"] / 2**20 for r in per],
                          launches=[r["launches"] for r in per], peak_memory_gib=[r["peak_memory_gib"] for r in per])
        got = [{k: r["launches"][k] for k in MAIN_KERNELS} for r in per]
        check(got == want, f"dist.cholesky {name}: launches {got} differ from the schedule's {want}")
    emit("dist.cholesky", config=f"{cfg.name}: n = {cfg.n_train}, tile {cfg.tile_size} (M = {m_tiles}), SE at the "
         f"paper's defaults, {p} x {q} grid of ranks on one card over gloo", rows=rows, schedule_launches=want,
         dense_f32_err=err32, max_abs_l64=scale, bound=bound,
         rule=f"float32: max|L - L64| <= 2 x dense float32 torch.linalg.cholesky error + 1e-4 max|L64|; bf16 update "
              f"on A A^T + n I (the reference's test matrix, tests/test_distributed_gp.py): max|L - L64| / max|L| < "
              f"{DIST_BF16_RTOL}",
         note="P x Q ranks sharing one H100, not multi-GPU scaling")
    check(rows["float32"]["max_abs_err"] <= bound, f"dist.cholesky: {rows['float32']['max_abs_err']} above {bound}")
    check(rows["bf16"]["rel_err"] < DIST_BF16_RTOL, f"dist.cholesky bf16: relative error {rows['bf16']['rel_err']}")


def report_predict(ranks, x, y, xt, yt, dev):
    """dist.predict against a float64 dense solve (PERF.md §2's rule) and beside the single-card port."""
    from repro_torch.configs.gp_msd import GP_DIST_32K as cfg
    from repro_torch.core import GaussianProcess
    from repro_torch.core import distributed as dgp

    p, q = DIST_GRID
    m_tiles = cfg.n_train // cfg.tile_size
    mean_ref, var_ref = dense_reference(x, y, xt, dev)
    mono = GaussianProcess(x, y, pipeline="monolithic", device=dev)
    mono.predict(xt[:1024])  # warm
    (mean_d, var_d), t_dense = wall_s(lambda: mono.predict_with_uncertainty(xt))
    del mono
    e, dense, mean_bound, var_bound = accuracy_bounds(mean_ref, var_ref, mean_d, var_d)
    del mean_d, var_d
    GaussianProcess(x[:4096], y[:4096], tile_size=1024, device=dev).predict_with_uncertainty(xt[:1024])  # warm
    single = GaussianProcess(x, y, tile_size=1024, device=dev)
    (mean_s, var_s), t_single = wall_s(lambda: single.predict_with_uncertainty(xt))
    del single
    torch.cuda.empty_cache()
    mean, var = ranks[0]["mean"].to(dev), ranks[0]["var"].to(dev)
    res = dict(mean_err=e(mean, mean_ref), var_err=e(var, var_ref), mean_err_single_card=e(mean_s, mean_ref),
               var_err_single_card=e(var_s, var_ref), dist_vs_single_card_mean=max_err(mean, mean_s),
               dist_vs_single_card_var=max_err(var, var_s), **dense, mean_bound=mean_bound, var_bound=var_bound,
               test_rmse=float(((mean.double() - torch.from_numpy(yt).to(dev)) ** 2).mean().sqrt()))
    digests = [float(mean.double().sum()), float(var.double().sum())]
    same = all(r["digest"] == digests for r in ranks[1:])
    want = [dgp.schedule_launches(m_tiles, p, q, pr, pc, predict=True) for pr in range(p) for pc in range(q)]
    got = [{k: r["launches"][k] for k in MAIN_KERNELS} for r in ranks]
    emit("dist.predict", config=f"{cfg.name}: n_train = {cfg.n_train}, n_test = {cfg.n_test}, tile {cfg.tile_size}, "
         f"{p} x {q} grid, distributed_gp_predict_fn with variances", accuracy=res, bound_rule=BOUND_RULE,
         replicated_on_every_rank=same,
         seconds={"dist_4_ranks_rank0_between_barriers": ranks[0]["seconds"],
                  "single_card_port_tiled_1024_cold": t_single, "dense_f32_monolithic_cold": t_dense},
         collective_host_s=[r["collective_host_s"] for r in ranks], collectives=[r["collectives"] for r in ranks],
         collective_mib_sent=[r["collective_bytes_sent"] / 2**20 for r in ranks],
         launches=[r["launches"] for r in ranks], schedule_launches=want,
         peak_memory_gib=[r["peak_memory_gib"] for r in ranks],
         note="4 ranks share one H100 over gloo (host-staged collectives): the algorithm, not multi-GPU scaling")
    DIST_COUNTS.update(collectives=ranks[0]["collectives_by_op"], launches=got[0], schedule=want[0])
    check(got == want, f"dist.predict: launches {got} differ from the schedule's {want}")
    check(same and bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "dist.predict: ranks disagree")
    check(res["mean_err"] <= mean_bound and res["var_err"] <= var_bound, f"dist.predict outside the rule: {res}")
    emit("dist.kernels", widest_launches=ranks[0]["plain"], tile=cfg.tile_size,
         note="each kernel's widest launch on rank 0's path, against its plain version")
    return ranks[0]["launches"], {k: r["max_abs_err"] for k, r in ranks[0]["plain"].items()}


def _fleet_results(batch, xtb, ragged, shared, each, xa, ya, waves):
    """fleet.sharded's calls on one GPBatch and one GPFleet: their results on the host, and their seconds."""
    from repro_torch.serve import ContinuousBatcher

    out, t = {}, {}
    out["batch_cold"], t["batch_cold"] = wall_s(lambda: batch.predict_with_uncertainty(xtb))
    out["batch_nlml"] = batch.nlml()
    out["batch_warm"], t["batch_warm"] = wall_s(lambda: batch.predict(xtb))
    out["ragged_cold"], t["ragged_cold"] = wall_s(lambda: ragged.predict_with_uncertainty(shared))
    out["ragged_each"], t["ragged_each"] = wall_s(lambda: ragged.predict_each(each))
    out["ragged_nlml"] = ragged.nlml()
    _, t["ragged_update"] = wall_s(lambda: ragged.update(xa, ya))
    out["ragged_warm"] = all(b.state is not None for b in ragged._buckets.values())
    out["ragged_after"], t["ragged_after"] = wall_s(lambda: ragged.predict(shared))
    srv, served = ContinuousBatcher(ragged), []
    t0 = time.perf_counter()
    for predicts, observes in waves:
        for p, x, y in observes:
            srv.submit_observe(p, x, y)
        ids = [srv.submit_predict(p, x, uncertainty=q) for p, x, q in predicts]
        srv.step()
        srv.flush()
        served += [srv.result(i) for i in ids]
    t["serve_waves"] = time.perf_counter() - t0
    out["served"] = served

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        return type(v)(host(u) for u in v) if isinstance(v, (list, tuple)) else v

    return {k: host(v) for k, v in out.items()}, t


def fleet_sharded_job(rank, world, fleet_args):
    """fleet.sharded: rank 0 runs the calls unsharded alone, then both ranks on a 2-rank data mesh, then rank 0
    on a 1-rank mesh; the plan cache is read after each."""
    import torch.distributed as dist

    from repro_torch.core import GPBatch, GPFleet, executor
    from repro_torch.launch.mesh import make_fleet_mesh

    xb, yb, xtb, xs, ys, shared, each, xa, ya = fleet_args
    meshes = {"none": None, "data2": make_fleet_mesh(2), "data1": make_fleet_mesh(1)}  # every rank makes each mesh
    dev = _here()
    waves = serve_traffic(len(xs), SEED, False)[:SHARDED_WAVES]
    out, seconds, plans = {}, {}, {}
    for name, mesh in meshes.items():
        dist.barrier()
        if rank != 0 and name != "data2":
            continue
        batch = GPBatch(xb, yb, tile_size=TILE, device=dev, mesh=mesh)
        ragged = GPFleet(xs, ys, tile_size=TILE, device=dev, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        out[name], seconds[name] = _fleet_results(batch, xtb, ragged, shared, each, xa, ya, waves)
        out[name]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[name]["batch_rows"] = batch.posterior().lpacked.shape[0]
        out[name]["ragged_rows"] = {cap: rec.state.lpacked.shape[0] for cap, rec in ragged._buckets.items()}
        info = executor.program_plan.cache_info()
        plans[name] = (info.misses, info.currsize)
        del batch, ragged
        torch.cuda.empty_cache()
    dist.barrier()
    return dict(results=out, seconds=seconds, plans=plans)


def dist_job(rank, world, factors, x, y, xt):
    """The 4-rank world's jobs in order: the probe, the Cholesky (the reference factors come by CUDA IPC), the
    prediction."""
    out = {"probe": probe_job(rank, world)}
    out["cholesky"] = cholesky_job(rank, world, x, *factors)
    del factors
    torch.cuda.empty_cache()
    out["predict"] = predict_job(rank, world, x, y, xt)
    return out


SHARDED_RESULTS = ("batch_cold", "batch_nlml", "batch_warm", "ragged_cold", "ragged_each", "ragged_nlml", "ragged_after",
                   "served")


def _diff(a, b, rel: bool = False):
    """(largest |a - b| (relative to |b| with ``rel``) over matching tensors, bitwise equal) of two results of one
    structure."""
    if rel:
        return _diff(a / b.abs(), b / b.abs()) if isinstance(a, torch.Tensor) else _diff(a, b)
    if isinstance(a, dict):
        parts = [_diff(a[k], b[k]) for k in a if k in b]
    elif isinstance(a, (list, tuple)):
        parts = [_diff(u, v) for u, v in zip(a, b)]
    elif isinstance(a, torch.Tensor):
        return (max_err(a, b) if a.numel() else 0.0), torch.equal(a, b)
    else:
        return 0.0, a == b
    return max([0.0] + [p[0] for p in parts]), all(p[1] for p in parts)


SHARDED_RULE = ("bitwise equal where the launches keep their widths (a 1-rank mesh, replicated buckets); where "
                "sharding narrows a launch, within the reference's 1e-5 (means and variances absolute, NLMLs "
                "relative): every tile kernel, tile_gemv and tile_trsv included, gives a tile the same result "
                "whatever the launch's width (width_invariance); the plain batched GEMV and triangular solve, "
                "which do not, are off the fleet path")


def width_invariance(dev):
    """Each tile op on G tiles and on the first G/2 of them: is a tile's result the same whatever the launch's width?

    At fleet.sharded's tile (512; a fleet of 16 against a rank's 8) and the distributed path's (128).
    """
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops

    out = {}
    for m, g in ((512, 32), (128, 64)):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        a, b, c = (torch.randn(g, m, m, device=dev, generator=gen) / m**0.5 for _ in range(3))
        spd = a @ a.mT + torch.eye(m, device=dev)
        low = torch.linalg.cholesky(spd).contiguous()
        xa, xb = (torch.randn(g, m, N_FEATURES, device=dev, generator=gen) / 4 for _ in range(2))
        se = km.SEKernelParams.paper_defaults()
        vec = torch.randn(g, m, device=dev, generator=gen)
        cases = {"potrf": lambda k: ops.potrf(spd[:k]), "trsm": lambda k: ops.trsm(low[:k], b[:k]),
                 "trail": lambda k: ops.trail(c[:k], a[:k], b[:k]),
                 "cov_tiles": lambda k: ops.cov_tiles(xa[:k], xb[:k], 0, 0, m, m, se, symmetric=False),
                 "tile_gemv": lambda k: ops.tile_gemv(a[:k, None, None], vec[:k, None, None]),
                 "tile_trsv": lambda k: ops.tile_trsv(low[:k, None], vec[:k, None], False)}
        for name, fn in cases.items():
            whole, half = fn(g)[: g // 2], fn(g // 2)
            out[f"{name}.m{m}"] = dict(widths=[g, g // 2], bitwise=torch.equal(whole, half),
                                       max_abs_diff=max_err(whole, half))
    # the plain batched contractions and solves of the executor's GEMV/TRSV steps, 16 problems against 8
    gen = torch.Generator(device=dev).manual_seed(SEED)
    z, g, m = 16, 4, 512
    tiles = torch.randn(z, g, m, m, device=dev, generator=gen) / m
    vec = torch.randn(z, g, m, device=dev, generator=gen)
    low = torch.linalg.cholesky(tiles @ tiles.mT + torch.eye(m, device=dev)).contiguous()
    plain = {"einsum zgab,zgb->zga": lambda k: torch.einsum("zgab,zgb->zga", tiles[:k], vec[:k]),
             "einsum zgqab,zqb->zga": lambda k: torch.einsum("zgqab,zqb->zga", tiles[:k, None], vec[:k]),
             "solve_triangular": lambda k: torch.linalg.solve_triangular(low[:k], vec[:k, ..., None], upper=False)}
    for name, fn in plain.items():
        whole, half = fn(z)[: z // 2], fn(z // 2)
        out[name] = dict(problems=[z, z // 2], bitwise=torch.equal(whole, half), max_abs_diff=max_err(whole, half))
    return out


def fleet_sharded_args():
    """fleet_batch's and fleet_ragged's data, and fleet.ragged's arrivals (two problems migrate)."""
    from repro_torch.core import tiling

    xb, yb, xtb, _ = fleet_data(FLEET_B, FLEET_N, FLEET_NT, SEED)
    ns, xs, ys, shared, each = ragged_data()
    assign = tiling.bucket_problems(ns, TILE)
    rng = np.random.default_rng(SEED + 2)
    arrive = [min(int(k), cap_of(assign, i) * TILE - int(ns[i])) for i, k in enumerate(rng.integers(0, 300, RAGGED_B))]
    movers = [idx[-1] for cap, idx in assign.items() if cap < max(assign)][-2:]
    for i in movers:
        arrive[i] = cap_of(assign, i) * TILE - int(ns[i]) + 100
    x_new, y_new, _, _ = make_data(sum(arrive), 1, N_FEATURES, SEED + 100)
    cuts = np.cumsum([0] + arrive)
    xa = [x_new[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    ya = [y_new[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    return (xb, yb, xtb, xs, ys, shared, each, xa, ya), assign, movers


def report_fleet_sharded(ranks, assign, movers):
    rows = {}
    unsharded = ranks[0]["results"]["none"]
    for r, res in enumerate(ranks):
        for name in ("data2", "data1"):
            if name in res["results"]:
                got, want = res["results"][name], unsharded
                by = {k: _diff(got[k], want[k], rel=k.endswith("nlml")) for k in SHARDED_RESULTS}
                worst = max(d for d, _ in by.values())
                rows[f"rank{r}.{name}"] = dict(max_diff=worst, bitwise=all(same for _, same in by.values()),
                                               within_1e_5=worst <= SHARDED_FLEET_TOL,
                                               by_result={k: d for k, (d, _) in by.items()})
    plans_same = len({v for res in ranks for v in res["plans"].values()}) == 1
    r0 = ranks[0]["results"]
    widths = width_invariance(_here())
    emit("fleet.sharded", config=f"fleet_batch ({FLEET_B} x {FLEET_N}, n_test {FLEET_NT}) and fleet_ragged ({RAGGED_B} "
         f"sizes in [{RAGGED_LO}, {RAGGED_HI}], pow2 buckets, a migrating update, {SHARDED_WAVES} ContinuousBatcher "
         f"waves), tile {TILE}, on a 2-rank ('data',) mesh and a 1-rank mesh, ranks sharing one card over gloo",
         against_unsharded=rows, rule=SHARDED_RULE, width_invariance=widths,
         plan_cache_by_mesh=[res["plans"] for res in ranks],
         plan_cache_identical=plans_same, buckets={cap: len(idx) for cap, idx in assign.items()},
         local_rows={"batch": {k: v["batch_rows"] for k, v in r0.items()},
                     "ragged_after_update": {k: v["ragged_rows"] for k, v in r0.items()}},
         migrated=movers, warm_after_update={k: v["ragged_warm"] for k, v in r0.items()},
         seconds_by_rank=[res["seconds"] for res in ranks],
         peak_memory_gib=[{k: v["peak_memory_gib"] for k, v in res["results"].items()} for res in ranks],
         note="'none': rank 0 alone, unsharded; 'data2': both ranks at once on one card; 'data1': rank 0 alone")
    check(rows["rank0.data1"]["bitwise"], f"fleet.sharded: a 1-rank mesh differs from no mesh: {rows}")
    check(all(v["max_diff"] <= SHARDED_FLEET_CARD_TOL for v in rows.values()), f"fleet.sharded against unsharded: {rows}")
    check(plans_same, f"fleet.sharded: the plan cache differs across world sizes: {[r['plans'] for r in ranks]}")
    check(all(v["ragged_warm"] for v in r0.values()), "fleet.sharded: a bucket went cold in the update")


def card_memory(before: str) -> None:
    free, total = torch.cuda.mem_get_info()
    emit("multi.memory", before=before, card_free_gib=free / 2**30, card_total_gib=total / 2**30,
         parent_allocated_gib=torch.cuda.memory_allocated() / 2**30,
         parent_reserved_gib=torch.cuda.memory_reserved() / 2**30)


def phase_multi(dev):
    """The multi-device phases: a 2-rank world (fleet.sharded) that runs while this process makes data.msd; a
    4-rank world (dist.probe, dist.cholesky, dist.predict, dist.kernels); and the phases' wall time."""
    t0 = time.perf_counter()
    fleet_args, assign, movers = fleet_sharded_args()
    card_memory("fleet.sharded")
    fleet_world = Ranks("fleet_sharded", 2, fleet_args)
    x, y, xt, yt = msd_data()
    fleet_ranks, t_fleet = fleet_world.join()
    report_fleet_sharded(fleet_ranks, assign, movers)
    del fleet_args, fleet_world
    torch.cuda.empty_cache()
    l64, err32 = dense_factor(x, dev)
    scale = float(l64.abs().max())
    factors = (l64, *spd_factor(x.shape[0], dev))
    card_memory("dist")
    p, q = DIST_GRID
    ranks, t_dist = Ranks("dist", p * q, x, y, xt, shared=factors).join()
    del l64, factors
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    report_probe([r["probe"] for r in ranks])
    report_cholesky([r["cholesky"] for r in ranks], err32, scale)
    launches, errs = report_predict([r["predict"] for r in ranks], x, y, xt, yt, dev)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit("multi.total", seconds=seconds, budget_s=MULTI_BUDGET_S, over_budget_s=seconds - MULTI_BUDGET_S,
         world_seconds={"dist": t_dist, "fleet_sharded": t_fleet},
         note="the multi-device phases' wall time, the data and the references included, against the budget")
    return launches, errs


# ---------------------------------------------------------------------------
# Language-model training: gemma2-2b at full width, gradients against the CPU, the trainer, meshes
# ---------------------------------------------------------------------------

# lm.train: gemma2-2b full width, bf16, LM_TRAIN_STEPS Adam steps on token_batches(V, B, S)
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 2, 2048, 3
LM_TRAIN_F32_RTOL = 2e-2     # step 0's bf16 loss against a float32 forward on the same weights
# lm.train.grad and lm.trainer: gemma2-2b at full width, depth cut to 2 layers, 1 x 512 tokens
LM_CUT_LAYERS, LM_GRAD_S = 2, 512
LM_GRAD_RULE = ("float32, each parameter: max |g_card - g_cpu| <= 1e-4 max |g_cpu| + 1e-6; bf16, each parameter: "
                "max |g_bf16 - g_f32| / max |g_f32| <= 2 x the same of the bf16 plain path (flash_attention_plain "
                "forward on the card) + 1e-3")
LM_TRAINER_STEPS, LM_TRAINER_EVERY = 6, 2
# lm.mesh: olmo-1b at full width, depth 2, float32, B x S = 4 x 512, on a 2 x 2 ("data", "model") world
LM_MESH_ARCH, LM_MESH_B, LM_MESH_S, LM_MESH_DECODE = "olmo-1b", 4, 512, 4
LM_MESH_TOL = 1e-5            # the sharded step, prefill and decode against unsharded (the reference's rule)
LM_MESH_UNRESOLVED_TOL = 5e-5  # parameters where the gradient is not resolved: 2.2x the 2.3e-5 measured there, 1/4 of
                               # the 2 lr of a step whose sign flipped
LM_MESH_COMPRESSED_M_TOL = 2e-2  # the compressed step's first moments against the plain step's, of their largest
LM_MESH_RULE = ("loss within 1e-5 relative; parameters within 1e-5 where the unsharded gradient is resolved (|g| > "
                "1e-4 max |g| of its parameter), elsewhere within 5e-5 (a step whose sign flipped is off by 2 lr = "
                "2e-4); first moments within 1e-5 of their parameter's largest; logits of prefill and decode within "
                "1e-5 max(1, max |logits|) (float32 GEMMs of another batch width). The compressed step: the "
                "reference's rule (loss within 1e-2, parameters within 5e-2 of the plain step), every rank's "
                "parameters and loss the same, and Adam's first moments (linear in the averaged gradient) within 2e-2 "
                "of their parameter's largest: the int8 mean is off by about 1/127 of a chunk's largest, a pod's "
                "gradient alone (no exchange over 'pod') by the order of the moments")
LM_MESH_LR = 1e-4
LM_NEW_BUDGET_S = 90.0        # the language-model training phases' share of the script's wall time


def lm_cut(cfg, **kw):
    return dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS, **kw)


def lm_batch(cfg, b, s, seed, dev, n=1):
    """``n`` batches of ``token_batches(V, b, s, seed)`` as int64 tensors on ``dev``."""
    from repro_torch.data.synthetic import token_batches

    return [(torch.from_numpy(t).long().to(dev), torch.from_numpy(l).long().to(dev))
            for t, l in token_batches(cfg.vocab_size, b, s, seed=seed, n_batches=n)]


def phase_lm_train(dev):
    """lm.train: three Adam steps of gemma2-2b at full width, bf16, through make_train_step."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adam, cosine_warmup
    from repro_torch.train import make_train_step

    cfg = configs.get_config(LM_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = tf.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batches = lm_batch(cfg, LM_TRAIN_B, LM_TRAIN_S, SEED, dev, LM_TRAIN_STEPS)
    # the float32 forward on the same weights, cast up and freed before the Adam state is made
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    model32 = copy.deepcopy(model).float()
    with torch.no_grad():
        loss32 = float(tf.loss_fn(model32, cfg32, *batches[0]))
    del model32
    torch.cuda.empty_cache()
    opt = Adam(learning_rate=cosine_warmup(3e-4, 1, 100))
    state = opt.init(model)
    step, _ = make_train_step(cfg, opt)
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if n in ("embed", "layers.0.attn.wq", f"layers.{cfg.n_layers - 1}.mlp.w_down", "final_norm.scale")}
    losses, seconds, flash, counts = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for inputs, labels in batches:
        ops.reset_launch_counts()
        (model, state, loss), t = wall_s(lambda: step(model, state, inputs, labels))
        counts.append(ops.launch_counts())
        flash.append(counts[-1]["flash_attention"])
        losses.append(float(loss))
        seconds.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {n: max_err(p, dict(model.named_parameters())[n]) for n, p in watch.items()}
    tokens = LM_TRAIN_B * LM_TRAIN_S
    rel0 = abs(losses[0] - loss32) / abs(loss32)
    emit("lm.train", arch=LM_ARCH, config="src/repro/configs/gemma2_2b.py, full width (26 layers), not cut",
         dtype=cfg.param_dtype, batch=[LM_TRAIN_B, LM_TRAIN_S], data="token_batches(V, 2, 2048, seed=0)",
         optimizer="Adam(cosine_warmup(3e-4, 1, 100)), clip 1.0", losses=losses, loss0_f32=loss32,
         loss0_rel_to_f32=rel0, tol=LM_TRAIN_F32_RTOL, step_seconds=seconds,
         tokens_per_s=[tokens / t for t in seconds], peak_memory_gib=peak, flash_launches_per_step=flash,
         flash_expected=2 * cfg.n_layers, launches_per_step=counts[-1], params_moved=moved,
         params=sum(p.numel() for p in model.parameters()), seconds=time.perf_counter() - t0,
         note="a step: forward (each block under checkpoint), backward (each block recomputed: the second flash "
         "launch; the attention backward is autograd of the reference's masked softmax, 512-query chunks), "
         "Adam; its time ends in torch.cuda.synchronize()")
    check(all(math.isfinite(x) for x in losses), f"lm.train: a loss is not finite: {losses}")
    check(rel0 <= LM_TRAIN_F32_RTOL, f"lm.train: step 0's loss {losses[0]} is {rel0} off the float32 {loss32}")
    check(all(f == 2 * cfg.n_layers for f in flash), f"lm.train: flash launches a step {flash}, not {2 * cfg.n_layers}")
    check(all(v > 0 for v in moved.values()), f"lm.train: parameters did not move: {moved}")
    return {k: sum(c[k] for c in counts) for k in counts[0]}, (model, state, step, batches[0], cfg, opt)


def profile_lm_train(model, state, step, batch, cfg, opt):
    """One training step under torch.profiler, and its parts by CUDA events: the forward and the chunked loss,
    forward + backward, the optimizer, the plain attention backward of the 26 layers, flash by kernel name."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import loss_and_grads

    inputs, labels = batch
    rows, busy, wall = profile_call("profile.lm.train", "one make_train_step step, gemma2-2b bf16, 2 x 2048",
                                    lambda: step(model, state, inputs, labels))
    flash = sum(ms for name, _, ms in rows if any(k in name for k in FLASH_KERNEL_NAMES))
    parts = {}
    with torch.no_grad():
        parts["forward_with_loss_ms"] = cuda_ms(lambda: tf.loss_fn(model, cfg, inputs, labels), 1)
    grads = {}

    def fwd_bwd():
        grads.update(loss_and_grads(model, cfg, inputs, labels)[1])

    parts["forward_backward_ms"] = cuda_ms(fwd_bwd, 1)
    parts["optimizer_ms"] = cuda_ms(lambda: opt.update(grads, state, model), 1, warmup=0)  # moves the weights
    del grads
    # the plain attention backward alone, at a layer's shapes (q, k, v as the projections give them)
    gen = torch.Generator(device=inputs.device).manual_seed(SEED)
    b, s, h, kv, hd = LM_TRAIN_B, LM_TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = torch.randn(b, s, h, hd, generator=gen, device=inputs.device).to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn(b, s, kv, hd, generator=gen, device=inputs.device).to(torch.bfloat16).requires_grad_()
            for _ in range(2))
    pos = torch.arange(s, device=inputs.device)[None].expand(b, s)
    cot = torch.randn(b, s, h, hd, generator=gen, device=inputs.device).to(torch.bfloat16)
    per_kind = {}
    for kind, window in (("local", cfg.window), ("global", None)):
        def ref_bwd():
            torch.autograd.grad(attn.attention_ref(q, k, v, pos, cfg, window), (q, k, v), cot)
        per_kind[kind] = cuda_ms(ref_bwd, 3)
    kinds = cfg.layer_kinds()
    parts["attention_backward_plain_ms"] = sum(per_kind[kd] for kd in kinds)
    parts["attention_backward_plain_ms_per_layer"] = per_kind
    parts["flash_ms_profiled"] = flash
    emit("profile.lm.train.parts", parts=parts, profiled_wall_ms=wall, profiled_busy_ms=busy,
         note="CUDA events, one call each after the profiled step; the attention backward is the reference's "
         "masked softmax recomputed and differentiated (attention_ref, 512-query chunks), timed alone at a "
         "layer's shapes and summed over the 26 layers; the optimizer is Adam over 2.6e9 parameters")


def lm_grads(model, cfg, batch):
    from repro_torch.train.train_step import loss_and_grads

    loss, grads = loss_and_grads(model, cfg, *batch)
    return float(loss), grads


def phase_lm_train_grad(dev):
    """lm.train.grad: gemma2-2b at full width, 2 layers: the card's float32 gradients against the CPU's, and its
    bf16 gradients against its float32 ones beside the bf16 plain path's.  The weights are drawn on the card
    (seeded) and copied to the CPU."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    full = configs.get_config(LM_ARCH)
    cfg32 = lm_cut(full, param_dtype="float32", activation_dtype="float32")
    cfg16 = lm_cut(full, param_dtype="bfloat16", activation_dtype="bfloat16")
    model32 = tf.init_model(cfg32, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = lm_batch(cfg32, 1, LM_GRAD_S, SEED + 1, "cpu")[0]
    t_cpu = time.perf_counter()
    loss_cpu, g_cpu = lm_grads(copy.deepcopy(model32).cpu(), cfg32, batch)
    t_cpu = time.perf_counter() - t_cpu
    dbatch = tuple(t.to(dev) for t in batch)
    ops.reset_launch_counts()
    loss32, g32 = lm_grads(model32, cfg32, dbatch)
    launches32 = ops.launch_counts()
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    model16.cfg = cfg16
    del model32
    loss16, g16 = lm_grads(model16, cfg16, dbatch)
    kernel = ops._flash.flash_attention_cuda
    ops._flash.flash_attention_cuda = flash_attention_plain  # the bf16 plain path, for its own error only
    try:
        loss16p, g16p = lm_grads(model16, cfg16, dbatch)
    finally:
        ops._flash.flash_attention_cuda = kernel
    del model16
    rows, bad = {}, []
    for n, gc in g_cpu.items():
        scale = float(gc.abs().max())
        e32 = max_err(g32[n].cpu(), gc)
        s32 = float(g32[n].abs().max())
        e16 = max_err(g16[n].float(), g32[n]) / s32 if s32 else 0.0
        e16p = max_err(g16p[n].float(), g32[n]) / s32 if s32 else 0.0
        rows[n] = dict(f32_abs_err=e32, f32_tol=1e-4 * scale + 1e-6, bf16_rel_err=e16, bf16_plain_rel_err=e16p,
                       bf16_tol=2 * e16p + 1e-3)
        if e32 > 1e-4 * scale + 1e-6 or e16 > 2 * e16p + 1e-3:
            bad.append(n)
    emit("lm.train.grad", arch=LM_ARCH, config=f"gemma2_2b at full width, depth cut to {LM_CUT_LAYERS} layers",
         reduced=[f"n_layers 26 -> {LM_CUT_LAYERS}"], tokens=[1, LM_GRAD_S],
         loss={"cpu_f32": loss_cpu, "card_f32": loss32, "card_bf16": loss16, "card_bf16_plain": loss16p},
         launches_f32=launches32, worst={k: max(r[k] for r in rows.values()) for k in
                                         ("f32_abs_err", "bf16_rel_err", "bf16_plain_rel_err")},
         by_param=rows, rule=LM_GRAD_RULE, cpu_seconds=t_cpu, seconds=time.perf_counter() - t0)
    check(launches32["flash_attention"] == 2 * LM_CUT_LAYERS,
          f"lm.train.grad: {launches32['flash_attention']} flash launches, not {2 * LM_CUT_LAYERS}")
    check(not bad, f"lm.train.grad: gradients outside the rule ({LM_GRAD_RULE}): {[(n, rows[n]) for n in bad]}")
    torch.cuda.empty_cache()


def phase_lm_trainer(dev):
    """lm.trainer: the Trainer at the gemma2-2b depth-2 cut, saving asynchronously every 2 of 6 steps; a second
    Trainer resumes from the checkpoint and its last losses are held to an uninterrupted run's."""
    import tempfile

    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adafactor
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = lm_cut(configs.get_config(LM_ARCH))
    opt = Adafactor(learning_rate=1e-3)
    step, _ = make_train_step(cfg, opt)
    data = lm_batch(cfg, 1, LM_GRAD_S, SEED + 2, dev, LM_TRAINER_STEPS)

    base = tf.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)

    def fresh(zeroed=False):
        model = copy.deepcopy(base)
        if zeroed:  # other weights: the checkpoint must replace them
            with torch.no_grad():
                for p in model.parameters():
                    p.zero_()
        return model, opt.init(model)

    def quiet(msg):
        pass

    parts = {}
    t = time.perf_counter()
    whole = Trainer(step, *fresh(), lambda i: data[i], log_every=0).run(LM_TRAINER_STEPS)
    parts["uninterrupted_s"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as ckpt:
        t = time.perf_counter()
        first = Trainer(step, *fresh(), lambda i: data[i], ckpt_dir=ckpt, ckpt_every=LM_TRAINER_EVERY,
                        ckpt_async=True, log_every=0, log_fn=quiet)
        r1 = first.run(LM_TRAINER_STEPS - 2)
        parts["first_run_with_saves_s"] = time.perf_counter() - t
        saved = CheckpointManager(ckpt).all_steps()
        del first
        torch.cuda.empty_cache()
        t = time.perf_counter()
        second = Trainer(step, *fresh(zeroed=True), lambda i: data[i], ckpt_dir=ckpt, ckpt_every=LM_TRAINER_EVERY,
                         log_every=0, log_fn=quiet)
        resumed = second.report.resumed_from
        parts["resume_s"] = time.perf_counter() - t
        r2 = second.run(2)
        del second, base
    want, got = whole.losses[-2:], r2.losses
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    emit("lm.trainer", config=f"gemma2_2b at full width, depth {LM_CUT_LAYERS}, bf16, Adafactor (factored moments: "
         "the checkpoint holds the bf16 weights and O(r + c) states), 1 x 512 tokens a step",
         reduced=[f"n_layers 26 -> {LM_CUT_LAYERS}"], steps=LM_TRAINER_STEPS, ckpt_every=LM_TRAINER_EVERY,
         async_saves=True, checkpoints=saved, resumed_from=resumed, uninterrupted_losses=whole.losses,
         first_run_losses=r1.losses, resumed_losses=got, rel_diff=rel, bitwise=got == want,
         stragglers=whole.stragglers,
         step_seconds=whole.step_times, parts_seconds=parts, seconds=time.perf_counter() - t0,
         note="bitwise where every op is deterministic; the embedding's backward adds rows with atomics")
    check(resumed == LM_TRAINER_STEPS - 2, f"lm.trainer: resumed from {resumed}, not {LM_TRAINER_STEPS - 2}")
    check(len(got) == 2 and all(r <= 1e-5 for r in rel), f"lm.trainer: resumed losses {got} against {want}")
    torch.cuda.empty_cache()



def lm_mesh_job(rank, world, ckpt_dir):
    """lm.mesh on one rank: the sharded train step (rank 0 also the unsharded one), a checkpoint of the sharded
    state, the compressed data-parallel step and sharded serving, with collectives, seconds and peak memory."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adam
    from repro_torch.train import make_compressed_dp_step, make_decode_step, make_prefill_step, make_train_step
    from repro_torch.train.train_step import loss_and_grads

    dev = _here()
    t_job = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(LM_MESH_ARCH), n_layers=LM_CUT_LAYERS, param_dtype="float32",
                              activation_dtype="float32")
    mesh = make_test_mesh((2, 2), ("data", "model"))
    pod = make_test_mesh((2, 2), ("pod", "data"))
    model = tf.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    tok, lab = lm_batch(cfg, LM_MESH_B, LM_MESH_S, SEED, dev)[0]
    opt = Adam(learning_rate=LM_MESH_LR)
    out, ref = {"full_bytes": sh.local_bytes(dict(model.named_parameters()))}, {}
    ref["grads"] = loss_and_grads(model, cfg, tok, lab)[1]  # on every rank: its first kernels load here, untimed
    if rank == 0:
        plain, _ = make_train_step(cfg, opt, donate=False)
        ref["params"], ref["opt"], ref["loss"] = plain(model, opt.init(model), tok, lab)
    else:
        del ref["grads"]
    dist.barrier()
    step, shardings = make_train_step(cfg, opt, mesh, ShapeConfig("lm_mesh", LM_MESH_S, LM_MESH_B, "train"))
    blocks = sh.distribute(dict(model.named_parameters()), shardings["params"])
    state = sh.distribute(opt.init(model), shardings["opt"])
    out["bytes"] = {"params": sh.local_bytes(blocks), "opt": sh.local_bytes(state)}
    out["bytes_expected"] = sum(math.prod(shardings["params"][n].block_shape(p.shape)) * p.element_size()
                                for n, p in model.named_parameters())
    torch.cuda.reset_peak_memory_stats()
    coll.reset_stats()
    (blocks, state, loss), out["step_seconds"] = timed_between_barriers(lambda: step(blocks, state, tok, lab))
    out["step_collectives"] = dict(coll.STATS)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    full_p, full_o = sh.collect(blocks, shardings["params"]), sh.collect(state, shardings["opt"])
    if rank == 0:
        out["train"] = dict(loss=[float(ref["loss"]), float(loss)], **step_errors(
            full_p, dict(ref["params"].named_parameters()), ref["grads"], LM_MESH_LR),
            m_err=max(max_err(full_o["m"][n], m) / max(1e-30, float(m.abs().max()))
                      for n, m in ref["opt"]["m"].items()))
        CheckpointManager(ckpt_dir).save(1, {"params": full_p, "opt": full_o})
    dist.barrier()
    if rank == 0:  # the sharded state's checkpoint, restored on one device without a mesh
        template = tf.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED + 1), dev)
        _, back = CheckpointManager(ckpt_dir).restore({"params": template, "opt": opt.init(template)})
        out["ckpt_unsharded_bitwise"] = (
            all(torch.equal(p, full_p[n]) for n, p in template.named_parameters())
            and all(torch.equal(back["opt"][k][n], full_o[k][n]) for k in ("m", "v") for n in full_o[k]))
        del template, back
    out["checkpoint_seconds"] = time.perf_counter() - t
    del full_p, full_o
    torch.cuda.empty_cache()
    # the compressed data-parallel step on ("pod", "data") = 2 x 2, compress_axis "pod"
    comp, init_err = make_compressed_dp_step(cfg, opt, pod, compress_axis="pod")
    coll.reset_stats()
    (p3, o3, err3, loss3), out["compressed_seconds"] = timed_between_barriers(
        lambda: comp(model, opt.init(model), init_err(model), tok, lab))
    out["compressed_collectives"] = dict(coll.STATS)
    # the parameters stay replicated: each one's sum and sum of squares, and the loss, the same on every rank
    out["compressed_digest"] = [[float(p.double().sum()), float(p.double().square().sum())]
                                for p in p3.parameters()] + [float(loss3)]
    if rank == 0:
        out["compressed"] = dict(loss=[float(ref["loss"]), float(loss3)],
                                 params_err=max(max_err(a, b) for a, b in
                                                zip(p3.parameters(), ref["params"].parameters())),
                                 m_err=max(max_err(o3["m"][n], m) / max(1e-30, float(m.abs().max()))
                                           for n, m in ref["opt"]["m"].items()),
                                 err_max=max(float(e.abs().max()) for e in err3.values()))
    del p3, o3, err3, ref
    torch.cuda.empty_cache()
    # prefill and greedy decode under the mesh, against unsharded on every rank
    serve_shape = ShapeConfig("lm_mesh_serve", LM_MESH_S + LM_MESH_DECODE, LM_MESH_B, "decode")
    (prefill, _), (decode, _) = make_prefill_step(cfg), make_decode_step(cfg)
    (prefill_sh, shp), (decode_sh, _) = make_prefill_step(cfg, mesh, serve_shape), make_decode_step(cfg, mesh,
                                                                                                    serve_shape)
    blocks = sh.distribute(dict(model.named_parameters()), shp["params"])
    coll.reset_stats()
    t_serve = time.perf_counter()
    logits, caches = prefill(model, tok, LM_MESH_S + LM_MESH_DECODE)
    (logits_sh, caches_sh), t_prefill = timed_between_barriers(
        lambda: prefill_sh(blocks, tok, LM_MESH_S + LM_MESH_DECODE))
    diffs, scales = [max_err(logits, logits_sh)], [float(logits.abs().max())]
    for i in range(LM_MESH_DECODE):
        token = logits.argmax(-1, keepdim=True)
        logits, caches = decode(model, token, LM_MESH_S + i, caches)
        logits_sh, caches_sh = decode_sh(blocks, token, LM_MESH_S + i, caches_sh)
        diffs.append(max_err(logits, logits_sh))
        scales.append(float(logits.abs().max()))
    out["serve"] = dict(diffs=diffs, max_abs_logits=scales, prefill_seconds=t_prefill,
                        cache_rows=caches_sh[0]["k"].shape[0], collectives=dict(coll.STATS))
    out["peak_memory_gib_all"] = torch.cuda.max_memory_allocated() / 2**30
    out["serve_seconds"] = time.perf_counter() - t_serve
    out["job_seconds"] = time.perf_counter() - t_job
    return out


def step_errors(got, want, grads, lr):
    """An Adam step against another: the largest difference where the gradient is resolved (|g| above 1e-4 of
    its parameter's largest), and elsewhere, where a first step moves by about lr whatever the sign of a g at
    its rounding level, with the count of such components."""
    resolved_err, other_err, other = 0.0, 0.0, 0
    for n, w in want.items():
        g = grads[n]
        ok = g.abs() > 1e-4 * g.abs().max()
        d = (got[n] - w).abs()
        resolved_err = max(resolved_err, float(torch.where(ok, d, 0.0).max()))
        other_err = max(other_err, float(torch.where(ok, 0.0, d).max()))
        other += int((~ok).sum())
    return dict(params_err=resolved_err, params_err_unresolved=other_err, unresolved=other, lr=lr)


def start_lm_mesh():
    """lm.mesh's 4-rank world, spawned to run beside this process's next phases: (world, its checkpoint dir)."""
    import tempfile

    ckpt = tempfile.TemporaryDirectory()
    return Ranks("lm_mesh", 4, ckpt.name), ckpt


def finish_lm_mesh(world, ckpt, beside):
    """lm.mesh: olmo-1b at full width, depth 2, on a 4-rank world over gloo on the one card; its report."""
    t0 = world.t0
    try:
        ranks, t_world = world.join()
    finally:
        ckpt.cleanup()
    r0 = ranks[0]
    block_bytes = [r["bytes"] for r in ranks]
    emit("lm.mesh", arch=LM_MESH_ARCH, config=f"src/repro/configs/olmo_1b.py at full width (d_model 2048, vocab "
         f"50304), depth cut to {LM_CUT_LAYERS}, float32, B x S = {LM_MESH_B} x {LM_MESH_S}",
         reduced=[f"n_layers 16 -> {LM_CUT_LAYERS}", "float32 (the config's bf16 for the 1e-5 rule)"],
         mesh="2 x 2 ('data', 'model') and 2 x 2 ('pod', 'data'), 4 ranks on one card over gloo",
         train=r0["train"], compressed=r0["compressed"],
         compressed_replicated=all(r["compressed_digest"] == r0["compressed_digest"] for r in ranks),
         ckpt_unsharded_bitwise=r0["ckpt_unsharded_bitwise"],
         serve_diffs=[r["serve"]["diffs"] for r in ranks], serve_max_abs_logits=r0["serve"]["max_abs_logits"],
         tol=LM_MESH_TOL, rule=LM_MESH_RULE,
         full_param_bytes=r0["full_bytes"], block_bytes=block_bytes,
         block_bytes_expected=[r["bytes_expected"] for r in ranks],
         step_seconds=[r["step_seconds"] for r in ranks], step_collectives=[r["step_collectives"] for r in ranks],
         compressed_seconds=[r["compressed_seconds"] for r in ranks],
         compressed_collectives=[r["compressed_collectives"] for r in ranks],
         serve_collectives=[r["serve"]["collectives"] for r in ranks],
         peak_memory_gib=[r["peak_memory_gib_all"] for r in ranks], world_seconds=t_world,
         checkpoint_seconds=r0["checkpoint_seconds"], serve_seconds=[r["serve_seconds"] for r in ranks],
         job_seconds=[r["job_seconds"] for r in ranks],
         seconds=time.perf_counter() - t0,
         ran_beside=beside,
         note="a step gathers each parameter (gather_axes), averages gradients over 'data' (psum), gathers the "
              "optimizer state, updates the full leaves and keeps the rank's blocks; compute is replicated over "
              "'model'; the ranks share one card, and the world "
              "runs beside this process's phases named in ran_beside, so these seconds show the algorithm, "
              "not scaling")
    tr, cp = r0["train"], r0["compressed"]
    check(abs(tr["loss"][0] - tr["loss"][1]) <= LM_MESH_TOL * abs(tr["loss"][0]) and tr["params_err"] <= LM_MESH_TOL
          and tr["params_err_unresolved"] <= LM_MESH_UNRESOLVED_TOL and tr["m_err"] <= LM_MESH_TOL,
          f"lm.mesh: the sharded step differs from unsharded ({LM_MESH_RULE}): {tr}")
    check(all(b["params"] == r["bytes_expected"] < r0["full_bytes"] and b["opt"] == 2 * r["bytes_expected"] + 4
              for b, r in zip(block_bytes, ranks)),
          f"lm.mesh: a rank holds other than its blocks: {block_bytes}, {[r['bytes_expected'] for r in ranks]}")
    check(abs(cp["loss"][0] - cp["loss"][1]) < 1e-2 and cp["params_err"] < 5e-2
          and cp["m_err"] <= LM_MESH_COMPRESSED_M_TOL and cp["err_max"] > 0.0,
          f"lm.mesh: the compressed step misses its rule ({LM_MESH_RULE}): {cp}")
    check(all(r["compressed_digest"] == r0["compressed_digest"] for r in ranks),
          "lm.mesh: the compressed step's parameters or loss differ across ranks")
    check(r0["ckpt_unsharded_bitwise"], "lm.mesh: the sharded state's checkpoint did not restore bitwise")
    check(all(d <= LM_MESH_TOL * max(1.0, m) for r in ranks for d, m in zip(r["serve"]["diffs"],
                                                                             r["serve"]["max_abs_logits"])),
          f"lm.mesh: sharded serving differs from unsharded: {[r['serve'] for r in ranks]}")
    torch.cuda.empty_cache()


# tile_trsv's dependent chain, read off csrc/tile_gemv_trsv.cu, in SM cycles (Hopper latencies: FFMA 4, a shared-
# memory load ~30, a distributed-shared-memory store landing on its mbarrier ~200, a DRAM load ~800, an IEEE
# division ~40).  A block's step: x_k's st.async landing and seen by try_wait (200); the update's 32-term dot
# product (a load, 8 dependent FMAs a partial, 2 adds: 70); the subtraction (4); r's exchange through shared
# memory (30); the inverse's dot product (70).  The first block adds its diagonal block's staging (one DRAM load)
# and inversion (32 rows of 8 dependent FMAs, 2 adds and a division: 32 x 80).
TRSV_CHAIN_CYCLES = {"step": 200 + 70 + 4 + 30 + 70, "first_block": 800 + 32 * 80}


def trsv_chain_floor(m: int, clock_mhz: float) -> dict:
    """The least time of tile_trsv's dependent chain at m (one system; the systems of a launch run side by side)."""
    nb = -(-m // 32)
    cycles = nb * TRSV_CHAIN_CYCLES["step"] + TRSV_CHAIN_CYCLES["first_block"]
    return {"ms": cycles / (clock_mhz * 1e3), "cycles": cycles, "blocks": nb, "cycles_per_block": TRSV_CHAIN_CYCLES["step"],
            "first_block_cycles": TRSV_CHAIN_CYCLES["first_block"], "sm_clock_mhz": clock_mhz}


def tile_vector_label(name: str):
    """'float32/gemv_rows/vector' for gemv_rows_kernel<float, true>, 'float64/trsv_upper/streaming' for
    trsv_cluster_kernel<double, true, false>."""
    k = re.search(r"gemv_(rows|cols)_kernelI([fd])Lb([01])E", name)
    if k:
        return f"{_TYPES[k.group(2)]}/gemv_{k.group(1)}/{'vector' if k.group(3) == '1' else 'scalar'}"
    k = re.search(r"trsv_cluster_kernelI([fd])Lb([01])ELb([01])E", name)
    if k:
        return (f"{_TYPES[k.group(1)]}/trsv_{'upper' if k.group(2) == '1' else 'lower'}/"
                f"{'resident' if k.group(3) == '1' else 'streaming'}")
    return None


def tile_vector_phase(dev):
    """kernel.tile_gemv and kernel.tile_trsv: the fleet's batch-invariant matvec and solve at fleet.batch's
    launches (XGEMV; a forward solve), against their plain versions (one problem at a time), beside one batched
    cuBLAS call, and the bitwise width invariance they exist for (16 problems against their first 8); the same
    for the GEMV_B route (fleet.batch's widest backward-sweep launch, tiles read transposed) and the transposed
    solve (kernel.tile_gemv.gemv_b, kernel.tile_trsv.transposed); then ptxas, CTAs per SM and the solve's plan and
    dependent-chain floor (kernel.tile_vector.extra)."""
    from repro_torch.kernels import _build, ops, tile_gemv_trsv as tv

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, q_tiles, m_tiles, m = FLEET_B, FLEET_NT // TILE, FLEET_N // TILE, TILE
    # XGEMV: the predictive mean's launch, (B, Q, M, m, m) cross tiles against (B, M, m) alpha, broadcast over Q
    rows = torch.randn(b, q_tiles, m_tiles, m, m, device=dev, generator=gen) / m
    alpha = torch.randn(b, m_tiles, m, device=dev, generator=gen)
    xb = alpha[:, None].expand(-1, q_tiles, -1, -1)
    # GEMV_B: the backward sweep's widest level, M - 1 packed tiles a problem read transposed (stride_a = 1)
    packed = torch.randn(b, m_tiles - 1, m, m, device=dev, generator=gen) / m
    cols, xc = packed.mT[:, :, None], torch.randn(b, m_tiles - 1, 1, m, device=dev, generator=gen)
    # TRSV: a forward-solve level's launch, one diagonal tile a problem (and the backward sweep's, transposed)
    a = torch.randn(b, 1, m, m, device=dev, generator=gen) / m**0.5
    low = torch.linalg.cholesky(a @ a.mT + torch.eye(m, device=dev)).contiguous()
    rhs = torch.randn(b, 1, m, device=dev, generator=gen)
    gemv_bytes = {"xgemv": (rows.numel() + alpha.numel() + b * q_tiles * m) * 4,
                  "gemv_b": (packed.numel() + xc.numel() + b * (m_tiles - 1) * m) * 4}
    trsv_bytes = (b * (m * (m + 1) // 2) + 2 * b * m) * 4

    def solve_lib(l, r, transpose):
        if transpose:
            return torch.linalg.solve_triangular(l.mT, r[..., None], upper=True)[..., 0]
        return torch.linalg.solve_triangular(l, r[..., None], upper=False)[..., 0]

    def gemv_case(aa, xx, nbytes):
        return dict(kern=lambda k=b: ops.tile_gemv(aa[:k], xx[:k]), plain=lambda: tv.tile_gemv_plain(aa, xx),
                    lib=lambda k=b: torch.einsum("zgqab,zgqb->zga", aa[:k], xx[:k]), nbytes=nbytes,
                    nops=2 * aa.numel(), shape=list(aa.shape), variant=tv.gemv_variant(aa, xx),
                    library_call="torch.einsum over the B problems (cuBLAS batched GEMV)")

    def trsv_case(transpose):
        return dict(kern=lambda k=b: ops.tile_trsv(low[:k], rhs[:k], transpose),
                    plain=lambda: tv.tile_trsv_plain(low, rhs, transpose),
                    lib=lambda k=b: solve_lib(low[:k], rhs[:k], transpose), nbytes=trsv_bytes, nops=b * m * m,
                    shape=list(low.shape),
                    library_call="torch.linalg.solve_triangular over the B problems")

    cases = {"tile_gemv": gemv_case(rows, xb, gemv_bytes["xgemv"]),
             "tile_gemv.gemv_b": gemv_case(cols, xc, gemv_bytes["gemv_b"]),
             "tile_trsv": trsv_case(False), "tile_trsv.transposed": trsv_case(True)}
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.split()[0])
    floor = trsv_chain_floor(m, clock)
    out = {}
    for name, c in cases.items():
        got, want = c["kern"](), c["plain"]()
        err = max_err(got, want)
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        half, lib_half = c["kern"](b // 2), c["lib"](b // 2)
        bnd = bound_ms(c["nbytes"], c["nops"])
        kernel = name.split(".")[0]
        row = dict(route="cuda", source="src/repro_torch/kernels/csrc/tile_gemv_trsv.cu",
                   replaces="none: a port-only kernel; the reference leaves the fleet's "
                   + ("GEMV/XGEMV steps" if kernel == "tile_gemv" else "TRSV steps")
                   + " to XLA (src/repro/core/executor.py:" + ("275)" if kernel == "tile_gemv" else "271)"),
                   max_abs_err=err, ms=device_ms(c["kern"], 20), plain_ms=cuda_ms(c["plain"], 5), bound_ms=bnd[0],
                   bound_by=bnd[1], library_ms=device_ms(c["lib"], 20), events_ms=cuda_ms(c["kern"], 20),
                   library_events_ms=cuda_ms(c["lib"], 20),
                   ms_note="ms and library_ms: device time a call (device_ms, torch.profiler); events_ms: CUDA "
                           "events around 20 back-to-back calls, which the host's launch cost paces")
        if kernel == "tile_trsv":
            row.update(chain_floor_ms=floor["ms"], bound_note="bytes bound beside the dependent chain's floor "
                       "(kernel.tile_vector.extra: trsv_chain_floor)")
        else:
            row.update(tb_per_s=c["nbytes"] / row["ms"] / 1e9, variant=c["variant"])
        emit(f"kernel.{name}", shape=c["shape"], tol=tol, bitwise_16_vs_8=torch.equal(got[: b // 2], half),
             library_bitwise_16_vs_8=torch.equal(c["lib"]()[: b // 2], lib_half), library_call=c["library_call"],
             **row)
        check(err <= tol, f"{name} disagrees with its plain version: {err} > {tol}")
        check(torch.equal(got[: b // 2], half), f"{name}: a problem's result changed with the launch's width")
        out[name] = row
    del rows, alpha, xb, packed, cols, xc, a, low, rhs
    torch.cuda.empty_cache()
    lib = _build.load("tile_gemv_trsv")
    ptxas = ptxas_report("tile_gemv_trsv", tile_vector_label)
    mma = sass_mma_counts("tile_gemv_trsv", tile_vector_label)
    ctas = {f"{t}/{v}": lib.tile_gemv_ctas_per_sm(i, int(t == "float64")) for t in ("float32", "float64")
            for i, v in enumerate(tv.GEMV_VARIANTS)}
    for t in ("float32", "float64"):
        for tr in (0, 1):
            key = f"{t}/trsv_{'upper' if tr else 'lower'}/m{m}"
            ctas[key] = lib.tile_trsv_occupancy(m, int(t == "float64"), tr, 0)
            ctas[key + "/clusters_on_the_card"] = lib.tile_trsv_occupancy(m, int(t == "float64"), tr, 1)
    plans = {f"{t}/m{mm}": tv.trsv_plan(mm, getattr(torch, t)) for t in ("float32", "float64")
             for mm in (32, 128, 512, 1024)}
    emit("kernel.tile_vector.extra", ptxas=ptxas, sass_hmma_count=mma, ctas_per_sm=ctas, trsv_plans=plans,
         trsv_chain_floor=floor, trsv_chain_cycles=TRSV_CHAIN_CYCLES,
         note="ctas_per_sm: CTAs of a variant an SM holds; a solve launch is one cluster a system")
    check_build_quality("tile_gemv_trsv", ptxas, mma)
    check(len(ptxas) == 16, f"tile_gemv_trsv: expected 16 instantiations in the ptxas report: {sorted(ptxas)}")
    trsv, gemv = out.pop("tile_trsv"), out.pop("tile_gemv")
    trsv["transposed"], gemv["gemv_b"] = out.pop("tile_trsv.transposed"), out.pop("tile_gemv.gemv_b")
    return {"tile_gemv": gemv, "tile_trsv": trsv}


# ---------------------------------------------------------------------------
# The recurrent layer kinds: recurrentgemma-2b and mamba2-1.3b at full width
# ---------------------------------------------------------------------------


def attention_layers(cfg) -> int:
    return sum(kind in ("local", "global") for kind in cfg.layer_kinds())


def lm_model(arch, dev, **kw):
    """(config, model): ``arch`` at full width (``kw`` replaces fields), weights drawn on the card from SEED."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(configs.get_config(arch), **kw)
    return cfg, tf.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)


def phase_lm_recurrent_serve(arch, dev):
    """lm.recurrent.serve: ``arch`` at full width serves LM_BATCHES, every launch counted (flash once a local
    layer a prefill, never in a step); lm.recurrent.decode_vs_full_forward: LM_RULE.  Returns (launches, model,
    config, prompts)."""
    from repro_torch.train import serve_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    (cfg, model), t_init = wall_s(lambda: lm_model(arch, dev))
    n_attn = attention_layers(cfg)
    emit("lm.recurrent.model", arch=arch, config=f"{cfg.source}; full width and depth, not cut",
         n_layers=cfg.n_layers, kinds={k: cfg.layer_kinds().count(k) for k in sorted(set(cfg.layer_kinds()))},
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=sum(p.numel() for p in model.parameters()),
         dtype=cfg.param_dtype, seed=SEED, init_seconds=t_init,
         weights_gib=(torch.cuda.memory_allocated() - base) / 2**30)
    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    rng = np.random.default_rng(SEED)
    prompts = {bs: torch.from_numpy(rng.integers(0, cfg.vocab_size, bs)).to(dev) for bs in LM_BATCHES}
    total, runs = dict(NO_LAUNCHES), {}
    for bs in LM_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        r = serve(prefill, decode, model, prompts[bs], LM_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for c in r["counts"]:
            total = {k: total[k] + c[k] for k in total}
        runs[bs] = r
        outs = [r["logits"], *r["step_logits"]]
        finite = all(bool(torch.isfinite(t.float()).all()) for t in outs)
        shapes = {tuple(t.shape) for t in outs}
        _, again = wall_s(lambda: prefill(model, prompts[bs], cache_len=bs[1] + LM_STEPS))
        steps = sorted(r["step_s"])
        emit("lm.recurrent.serve", arch=arch, batch=list(bs), steps=LM_STEPS,
             flash_launches_prefill=r["counts"][0]["flash_attention"],
             flash_launches_per_step=[c["flash_attention"] for c in r["counts"][1:]],
             launches_prefill=r["counts"][0], finite=finite, shapes=sorted(shapes),
             tokens_first_request=r["fed"][0].tolist(), prefill_seconds=r["prefill_s"],
             prefill_seconds_second_call=again, prefill_tokens_per_s=bs[0] * bs[1] / again,
             decode_ms_per_step_median=1e3 * steps[len(steps) // 2], step_seconds=r["step_s"], peak_memory_gib=peak,
             note="host clock around calls ending in torch.cuda.synchronize(); peak memory includes the bf16 "
             "weights; the second prefill is timed after the first warmed cuBLAS")
        check(r["counts"][0] == {**NO_LAUNCHES, "flash_attention": n_attn},
              f"{arch} prefill {bs}: launches {r['counts'][0]}, not flash once on each of {n_attn} local layers")
        check(all(c == NO_LAUNCHES for c in r["counts"][1:]), f"{arch} decode {bs}: a step launched a kernel: "
              f"{[c for c in r['counts'][1:] if c != NO_LAUNCHES][:1]}")
        check(finite and shapes == {(bs[0], cfg.vocab_size)}, f"{arch} serve {bs}: non-finite or misshapen logits")
    decode_vs_full_forward("lm.recurrent.decode_vs_full_forward", model, cfg, prompts, runs)
    emit("lm.recurrent.serve.total", arch=arch, seconds=time.perf_counter() - t0)
    return total, model, cfg, prompts


def profile_lm_recurrent(model, cfg, prompts, dev):
    """profile.lm.recurrent: one prefill of the first batch under torch.profiler (top kernels, flash and matmul
    shares, idle share), and the scans alone at that prefill's shapes by CUDA events, summed over the layers."""
    from repro_torch.models import mamba2 as m2
    from repro_torch.models.layers import linear_scan
    from repro_torch.train import serve_step

    prefill = serve_step.make_prefill_step(cfg)[0]
    b, s = LM_BATCHES[0]
    prompt = prompts[(b, s)]
    rows, busy, wall = profile_call("profile.lm.recurrent", f"prefill {b} x {s}, {cfg.name} bf16",
                                    lambda: prefill(model, prompt, cache_len=s + 1))
    flash = sum(ms for name, _, ms in rows if any(k in name for k in FLASH_KERNEL_NAMES))
    mm = sum(ms for name, _, ms in rows if any(w in name.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if "rglru" in cfg.layer_kinds():  # (B, S, w) decays and inputs, float32
        shape, lead, n = (b, s, cfg.rnn_width_), (b, s, cfg.rnn_width_), cfg.layer_kinds().count("rglru")
    else:  # (B, NC, H) chunk decays over (B, NC, H, N, P) chunk states
        _, h, pd, nst = m2._dims(cfg)
        lead, n = (b, s // cfg.ssm_chunk, h), cfg.n_layers
        shape = lead + (nst, pd)
    a = torch.rand(lead, generator=gen, device=dev)
    x = torch.randn(shape, generator=gen, device=dev)
    scan_ms = cuda_ms(lambda: linear_scan(a, x), 5)
    emit("profile.lm.recurrent.shares", arch=cfg.name, flash_ms=flash, matmul_ms=mm, other_ms=busy - flash - mm,
         busy_ms=busy, scan_ms_per_layer=scan_ms, scan_shape=list(shape), scan_layers=n,
         scan_ms_summed=scan_ms * n, scan_share_of_busy=scan_ms * n / busy if busy else "not measured",
         note="the scan by CUDA events outside the profiler, at the prefill's shapes, times its layers")
    del a, x
    if rows and "local" in cfg.layer_kinds():
        check(flash > 0, f"profile.lm.recurrent: {cfg.name}'s prefill profiled 0 ms of flash")


def lm_train_batches(cfg, b, s, seed, dev, n=1):
    """``n`` batches of ``token_batches(V, b, s, seed)``; for the embeddings input the inputs are seeded normal
    (b, s, d) float32 embeddings (as the reference's tests draw them) and the labels stay the tokens'."""
    batches = lm_batch(cfg, b, s, seed, dev, n)
    if cfg.input_mode != "embeddings":
        return batches
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(b, s, cfg.d_model, generator=gen, device=dev), labels) for _, labels in batches]


def phase_lm_cell_train(phase, arch, dev, cut=None):
    """``phase``: LM_REC_TRAIN_STEPS Adam steps of ``arch`` at full width (depth cut to ``cut``), bf16, through
    make_train_step; step 0's loss against a float32 forward on the same weights.  Returns the launches summed over
    the steps."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adam, cosine_warmup
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, model = lm_model(arch, dev, **({} if cut is None else {"n_layers": cut}))
    batches = lm_train_batches(cfg, LM_TRAIN_B, LM_TRAIN_S, SEED, dev, LM_REC_TRAIN_STEPS)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    model32 = copy.deepcopy(model).float()
    with torch.no_grad():
        loss32 = float(tf.loss_fn(model32, cfg32, *batches[0]))
    del model32
    torch.cuda.empty_cache()
    opt = Adam(learning_rate=cosine_warmup(3e-4, 1, 100))
    state = opt.init(model)
    step, _ = make_train_step(cfg, opt)
    # the weight matrices of the first and last layers: a bf16 vector at 1.0 (Mamba-2's norm_scale) has an ulp of
    # 2^-7, which a first step's ~lr does not reach; the embedding table of the embeddings input takes no gradient
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if (n == "embed" and cfg.input_mode == "tokens")
             or (p.ndim >= 2 and n.startswith(("layers.0.", f"layers.{cfg.n_layers - 1}.")))}
    losses, seconds, counts = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for inputs, labels in batches:
        ops.reset_launch_counts()
        (model, state, loss), t = wall_s(lambda: step(model, state, inputs, labels))
        counts.append(ops.launch_counts())
        losses.append(float(loss))
        seconds.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {n: max_err(p, dict(model.named_parameters())[n]) for n, p in watch.items()}
    n_attn, ln_v = attention_layers(cfg), math.log(cfg.vocab_size)
    rel0 = abs(losses[0] - loss32) / abs(loss32)
    tokens = LM_TRAIN_B * LM_TRAIN_S
    depth = "full width and depth, not cut" if cut is None else f"full width, depth cut to {cut}"
    emit(phase, arch=arch, config=f"{cfg.source}; {depth}",
         reduced=[] if cut is None else [f"n_layers {configs.get_config(arch).n_layers} -> {cut}"],
         dtype=cfg.param_dtype, batch=[LM_TRAIN_B, LM_TRAIN_S], data=f"token_batches(V, {LM_TRAIN_B}, "
         f"{LM_TRAIN_S}, seed={SEED})" + (" labels; inputs seeded normal (B, S, d) embeddings"
                                           if cfg.input_mode == "embeddings" else ""),
         optimizer="Adam(cosine_warmup(3e-4, 1, 100)), clip 1.0", losses=losses,
         ln_vocab=ln_v, loss_rtol_to_ln_vocab=LM_REC_LOSS_RTOL, loss0_f32=loss32, loss0_rel_to_f32=rel0,
         tol=LM_TRAIN_F32_RTOL, step_seconds=seconds, tokens_per_s=[tokens / t for t in seconds],
         peak_memory_gib=peak, flash_launches_per_step=[c["flash_attention"] for c in counts],
         flash_expected=2 * n_attn, launches_per_step=counts[-1], params_moved=moved,
         params=sum(p.numel() for p in model.parameters()), seconds=time.perf_counter() - t0,
         note="a step: forward (each block under checkpoint), backward (each block recomputed: an attention layer's "
         "second flash launch; the attention backward, the scans and the MoE by autograd of plain torch), Adam")
    check(all(math.isfinite(x) and abs(x - ln_v) <= LM_REC_LOSS_RTOL * ln_v for x in losses),
          f"{phase} {arch}: losses {losses} not finite or not near ln V = {ln_v}")
    check(rel0 <= LM_TRAIN_F32_RTOL, f"{phase} {arch}: step 0's loss {losses[0]} is {rel0} off the float32 {loss32}")
    check(all(c == {**NO_LAUNCHES, "flash_attention": 2 * n_attn} for c in counts),
          f"{phase} {arch}: launches a step {counts}, not flash twice on each of {n_attn} attention layers")
    check(all(v > 0 for v in moved.values()), f"{phase} {arch}: parameters did not move: {moved}")
    del model, state, batches
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_lm_cell_grad(phase, arch, cut, dev):
    """``phase``: ``arch`` at full width, depth cut to ``cut``, float32, 1 x LM_GRAD_S tokens (or embeddings):
    the card's gradients against the CPU's, each parameter, under LM_GRAD_RULE's float32 part."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg, model = lm_model(arch, dev, n_layers=cut, param_dtype="float32", activation_dtype="float32")
    batch = lm_train_batches(cfg, 1, LM_GRAD_S, SEED + 1, "cpu")[0]
    t_cpu = time.perf_counter()
    loss_cpu, g_cpu = lm_grads(copy.deepcopy(model).cpu(), cfg, batch)
    t_cpu = time.perf_counter() - t_cpu
    ops.reset_launch_counts()
    loss32, g32 = lm_grads(model, cfg, tuple(t.to(dev) for t in batch))
    launches = ops.launch_counts()
    rows, bad = {}, []
    for n, gc in g_cpu.items():
        tol = 1e-4 * float(gc.abs().max()) + 1e-6
        rows[n] = dict(f32_abs_err=max_err(g32[n].cpu(), gc), f32_tol=tol)
        if rows[n]["f32_abs_err"] > tol:
            bad.append(n)
    n_attn = attention_layers(cfg)
    emit(phase, arch=arch, config=f"{cfg.source}; full width, depth cut to {cfg.n_layers} layers "
         f"({', '.join(cfg.layer_kinds())})", reduced=[f"n_layers -> {cfg.n_layers}"], tokens=[1, LM_GRAD_S],
         inputs=cfg.input_mode, loss={"cpu_f32": loss_cpu, "card_f32": loss32}, launches=launches,
         worst=max(r["f32_abs_err"] for r in rows.values()), by_param=rows,
         rule="LM_GRAD_RULE's float32 part: " + LM_GRAD_RULE.split(";")[0], cpu_seconds=t_cpu,
         seconds=time.perf_counter() - t0)
    check(launches == {**NO_LAUNCHES, "flash_attention": 2 * n_attn},
          f"{phase} {arch}: launches {launches}, not flash twice on each of {n_attn} attention layers")
    check(not bad, f"{phase} {arch}: gradients outside the rule: {[(n, rows[n]) for n in bad]}")
    del model, g32
    torch.cuda.empty_cache()


def phase_lm_recurrent(dev):
    """The recurrent group: each of LM_REC_ARCHS served (and profiled), trained and its gradients checked;
    lm.recurrent.total against LM_REC_BUDGET_S (the profiles not counted).  Returns the launches by path."""
    seconds, serve_launches, train_launches = 0.0, dict(NO_LAUNCHES), dict(NO_LAUNCHES)
    for arch in LM_REC_ARCHS:
        t = time.perf_counter()
        launches, model, cfg, prompts = phase_lm_recurrent_serve(arch, dev)
        seconds += time.perf_counter() - t
        serve_launches = {k: serve_launches[k] + launches[k] for k in serve_launches}
        profile_lm_recurrent(model, cfg, prompts, dev)
        del model, prompts
    t = time.perf_counter()
    for arch in LM_REC_ARCHS:
        launches = phase_lm_cell_train("lm.recurrent.train", arch, dev)
        train_launches = {k: train_launches[k] + launches[k] for k in train_launches}
    for arch in LM_REC_ARCHS:
        phase_lm_cell_grad("lm.recurrent.grad", arch, LM_REC_CUT[arch], dev)
    seconds += time.perf_counter() - t
    emit("lm.recurrent.total", seconds=seconds, budget_s=LM_REC_BUDGET_S,
         note="lm.recurrent.serve (with decode_vs_full_forward), .train and .grad of both models by the script's "
         "clock; profile.lm.recurrent not counted")
    check(seconds <= LM_REC_BUDGET_S, f"the recurrent phases took {seconds} s of {LM_REC_BUDGET_S}")
    return {"lm.recurrent": serve_launches, "lm.recurrent.train": train_launches}


# ---------------------------------------------------------------------------
# The rest of the language-model scaffold: the MoE feed-forward and the embeddings input
# ---------------------------------------------------------------------------

# arch -> (the served cell's depth, None: not cut; the depth LM_RULE's float32 side runs at, None: the served model)
LM_ARCH_CELLS = {
    "qwen3-moe-235b-a22b": (8, 1),
    "arctic-480b": (2, 1),
    "llava-next-34b": (None, 4),
    "musicgen-large": (None, None),
}
LM_ARCH_TRAIN = {"qwen3-moe-235b-a22b": 1, "musicgen-large": None}  # arch -> depth it trains at (None: not cut)
# LM_RULE's MoE cells (depth 1) route at capacity factor 8, 8x the mean load: at the served 1.25 the seeded random
# router's skew (layer 0's busiest expert takes 2.9-4.7x the mean on qwen3-moe) drops a choice of the compared token
# in every full forward, and a dropped choice makes the full forward another function than the decode, whose B
# tokens a step never drop
LM_ARCH_RULE_CF = 8.0
LM_ARCH_GRAD_CUT = 2            # musicgen's depth in lm.embed.grad; lm.moe.grad takes one qwen3-moe block
LM_ARCH_BUDGET_S = 120.0        # the new phases' share of the script's wall time (the profile not counted)
LM_ARCH_FLASH = (4, 2048)       # kernel.flash.lm_shapes: B, S = T of each new model's prefill
LM_ARCH_NOT_TRAINED = (
    "arctic-480b and llava-next-34b do not train on the card: arctic's one layer with its bf16 gradients and Adam's "
    "float32 moments is 13.6e9 x 12 B = 163 GB, llava's whole model 413 GB, past the card's 80 GB; their training "
    "is held on the CPU at smoke size (tests/test_torch_lm_train.py)")


def arch_group(cfg) -> str:
    return "lm.moe" if cfg.n_experts else "lm.embed"


def arch_prompts(cfg, dev):
    """LM_BATCHES prompts: token ids, or for the embeddings input seeded normal (B, S, d) float32 embeddings."""
    if cfg.input_mode == "embeddings":
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return {bs: torch.randn(*bs, cfg.d_model, generator=gen, device=dev) for bs in LM_BATCHES}
    rng = np.random.default_rng(SEED)
    return {bs: torch.from_numpy(rng.integers(0, cfg.vocab_size, bs)).to(dev) for bs in LM_BATCHES}


def route_stats(records, n_experts):
    """Of one call's MoE routing records (one a layer): dropped choices and the largest expert load over the mean,
    a layer each."""
    dropped, load = [], []
    for r in records:
        counts = torch.bincount(r["expert"].reshape(-1), minlength=n_experts).float()
        dropped.append(int((~r["kept"]).sum()))
        load.append(float(counts.max() / counts.mean()))
    return {"dropped_by_layer": dropped, "max_load_over_mean_by_layer": load}


def step_routes(records, i, layers):
    """The records of decode step ``i`` of a served batch recorded whole (the prefill's ``layers`` calls first)."""
    return records[layers * (1 + i):layers * (2 + i)]


def last_routes(records, b):
    """The last position's routing of each record of a full forward over ``b`` rows."""
    return [{k: r[k].reshape(b, -1, r[k].shape[-1])[:, -1] for k in ("expert", "kept")} for r in records]


def compare_routes(runs):
    """Whether every run routes each row's compared token alike in every MoE layer, the same experts and every
    choice kept: ``runs`` {name: [a layer's {"expert": (B, k), "kept": (B, k)}]}; the flips are against the first."""
    names = list(runs)
    base = [r["expert"].sort(-1).values for r in runs[names[0]]]
    flipped = {n: [(r["expert"].sort(-1).values != e).any(-1) for r, e in zip(runs[n], base)] for n in names[1:]}
    dropped = {n: [(~r["kept"]).sum(-1) for r in runs[n]] for n in names}
    bad = torch.zeros_like(base[0][:, 0], dtype=torch.bool)
    for layers in (*flipped.values(), *dropped.values()):
        for t in layers:
            bad |= t > 0
    return {"alike_rows": (~bad).tolist(),
            f"rows_flipped_against_{names[0]}_by_layer": {n: [int(t.sum()) for t in v] for n, v in flipped.items()},
            "dropped_by_layer": {n: [int(t.sum()) for t in v] for n, v in dropped.items()}}


def flash_lm_shapes(dev):
    """kernel.flash.lm_shapes: the flash kernel at the prefill shape (LM_ARCH_FLASH, causal, bf16, no softcap) of each
    head layout of the new models (qwen3-moe: 64 query heads on 4 KV heads of 128; arctic and llava: 56 on 8, an
    odd group of 7; musicgen: 32 on 32 of 64) against its plain version, beside its bound and SDPA."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ops

    b, s = LM_ARCH_FLASH
    shapes = {}
    for arch in LM_ARCH_CELLS:
        cfg = configs.get_config(arch)
        shapes.setdefault((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.attn_softcap), []).append(arch)
    res = {}
    for (h, kv, hd, cap), archs in shapes.items():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, s, kv, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        ops.reset_launch_counts()
        out = ops.flash_attention(q, k, v, softcap=cap)
        check(ops.launch_counts()["flash_attention"] == 1, f"flash_attention {archs}: the kernel did not launch")
        ref = fa.flash_attention_plain(q, k, v, softcap=cap).float()
        err = max_err(out, ref)
        scaled = float(((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max())
        check(scaled <= 2e-2, f"flash_attention {archs}: kernel disagrees with its plain version: {scaled} > 2e-2 "
              f"(scaled), {err} (absolute)")
        del ref
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        nb = (2 * b * s * h * hd + 2 * b * s * kv * hd) * 2
        no = 4 * hd * attention_pairs(s, s, None) * b * h
        bnd = bound_ms(nb, no, PEAK_BF16_FLOPS)
        r = dict(archs=archs, shape={"B": b, "S": s, "T": s, "H": h, "KV": kv, "group": h // kv, "hd": hd,
                                     "softcap": cap, "dtype": "bfloat16"},
                 max_abs_err=err, max_scaled_err=scaled, tol=2e-2,
                 ms=cuda_ms(lambda: ops.flash_attention(q, k, v, softcap=cap), 10),
                 plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, softcap=cap), 3),
                 bound_ms=bnd[0], bound_by=bnd[1], library_ms=cuda_ms(sdpa, 10),
                 sdpa_vs_kernel_max_abs_err=max_err(sdpa().transpose(1, 2), out))
        r["achieved_tflops"] = no / r["ms"] / 1e9
        res["/".join(archs)] = r
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    emit("kernel.flash.lm_shapes", shapes=res, tol_rule="max |kernel - plain| / max(1, |plain|) <= 2e-2 (bf16, as "
         "kernel.flash)", library_call="torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
         "enable_gqa=True) on (B, H, S, hd) copies")
    return res


def serve_cell(arch, cut, dev):
    """lm.moe.serve / lm.embed.serve: ``arch`` at full width (depth cut to ``cut``) serves LM_BATCHES, every launch
    counted (flash once an attention layer a prefill, never in a step), with the MoE's drops and expert loads.
    Returns (launches, model, config, prompts, runs)."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.train import serve_step

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    (cfg, model), t_init = wall_s(lambda: lm_model(arch, dev, **({} if cut is None else {"n_layers": cut})))
    group = arch_group(cfg)
    n_layers = configs.get_config(arch).n_layers
    emit(f"{group}.model", arch=arch, config=f"{cfg.source}; full width" + (
        ", depth cut" if cut else " and depth, not cut"), reduced=[f"n_layers {n_layers} -> {cut}"] if cut else [],
         n_layers=cfg.n_layers, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_],
         d_ff=cfg.d_ff, experts=[cfg.n_experts, cfg.experts_per_token, cfg.moe_d_ff] if cfg.n_experts else None,
         dense_residual=cfg.dense_residual, capacity_factor=cfg.capacity_factor if cfg.n_experts else None,
         router_group_size=cfg.router_group_size if cfg.n_experts else None, inputs=cfg.input_mode,
         vocab=cfg.vocab_size, params=sum(p.numel() for p in model.parameters()),
         param_count_config=cfg.param_count(), dtype=cfg.param_dtype, seed=SEED, init_seconds=t_init,
         weights_gib=(torch.cuda.memory_allocated() - base) / 2**30)
    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    prompts = arch_prompts(cfg, dev)
    n_attn = attention_layers(cfg)
    total, runs = dict(NO_LAUNCHES), {}
    for bs in LM_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        with moe.recording() as rec:
            r = serve(prefill, decode, model, prompts[bs], LM_STEPS)
        r["routes"] = rec
        peak = torch.cuda.max_memory_allocated() / 2**30
        for c in r["counts"]:
            total = {k: total[k] + c[k] for k in total}
        runs[bs] = r
        outs = [r["logits"], *r["step_logits"]]
        finite = all(bool(torch.isfinite(t.float()).all()) for t in outs)
        shapes = {tuple(t.shape) for t in outs}
        _, again = wall_s(lambda: prefill(model, prompts[bs], cache_len=bs[1] + LM_STEPS))
        steps = sorted(r["step_s"])
        routing = {}
        if cfg.n_experts:
            per_step = [route_stats(step_routes(rec, i, cfg.n_layers), cfg.n_experts) for i in range(LM_STEPS)]
            g = moe.group_size(bs[0] * bs[1], cfg)
            routing = dict(prefill_routing=route_stats(rec[:cfg.n_layers], cfg.n_experts),
                           decode_dropped=sum(sum(st["dropped_by_layer"]) for st in per_step),
                           decode_max_load_over_mean=max(max(st["max_load_over_mean_by_layer"]) for st in per_step),
                           groups_prefill=[bs[0] * bs[1] // g, g], capacity_prefill=moe.capacity(g, cfg),
                           capacity_decode=moe.capacity(bs[0], cfg))
        emit(f"{group}.serve", arch=arch, batch=list(bs), steps=LM_STEPS,
             prompt="token ids" if cfg.input_mode == "tokens" else "seeded normal (B, S, d) embeddings; the decoded "
             "tokens go in through embed",
             flash_launches_prefill=r["counts"][0]["flash_attention"],
             flash_launches_per_step=[c["flash_attention"] for c in r["counts"][1:]],
             launches_prefill=r["counts"][0], finite=finite, shapes=sorted(shapes),
             tokens_first_request=r["fed"][0].tolist(), prefill_seconds=r["prefill_s"],
             prefill_seconds_second_call=again, prefill_tokens_per_s=bs[0] * bs[1] / again,
             decode_ms_per_step_median=1e3 * steps[len(steps) // 2], step_seconds=r["step_s"], peak_memory_gib=peak,
             **routing, note="host clock around calls ending in torch.cuda.synchronize(); peak memory includes the "
             "bf16 weights; the second prefill is timed after the first warmed cuBLAS")
        check(r["counts"][0] == {**NO_LAUNCHES, "flash_attention": n_attn},
              f"{arch} prefill {bs}: launches {r['counts'][0]}, not flash once on each of {n_attn} attention layers")
        check(all(c == NO_LAUNCHES for c in r["counts"][1:]), f"{arch} decode {bs}: a step launched a kernel: "
              f"{[c for c in r['counts'][1:] if c != NO_LAUNCHES][:1]}")
        check(finite and shapes == {(bs[0], cfg.vocab_size)}, f"{arch} serve {bs}: non-finite or misshapen logits")
        if cfg.n_experts:
            check(routing["decode_dropped"] == 0, f"{arch} decode {bs}: a step dropped {routing['decode_dropped']} "
                  f"choices, where B tokens at capacity {routing['capacity_decode']} fit")
    return total, model, cfg, prompts, runs


def served_decode_gaps(model, cfg, prompts, runs, cut32):
    """{lm.moe, lm.embed}.decode_vs_full_forward.served: the bf16 decode at the served depth against its bf16 full
    forwards, reported with the full forwards' MoE drops, a layer each; LM_RULE is held at depth ``cut32``, where the
    float32 model fits (decode_rule_at_cut)."""
    from repro_torch.models import moe

    routes = {}
    full16 = full_forwards(model, cfg, prompts, runs, routes)
    for bs, r in runs.items():
        res = {}
        for i in LM_CHECKED:
            e = res[f"token_{bs[1] + i}"] = dict(gap_bf16=max_err(r["step_logits"][i], full16[bs][i]),
                                                 max_abs_logit=float(full16[bs][i].abs().max()))
            if cfg.n_experts:
                n_tok = bs[0] * (bs[1] + i + 1)
                g = moe.group_size(n_tok, cfg)
                e.update(full_forward_groups=[n_tok // g, g], full_forward_capacity=moe.capacity(g, cfg),
                         full_forward_routing=route_stats(routes[bs][i], cfg.n_experts),
                         routing=compare_routes({"decode_bf16": step_routes(r["routes"], i, cfg.n_layers),
                                                 "full_bf16": last_routes(routes[bs][i], bs[0])}))
        note = (f"bf16 alone at the served depth (reported, not held): a full forward over S + i + 1 tokens routes "
                f"them in other groups than the prefill of S (one group of all of them where "
                f"{cfg.router_group_size} does not divide the count), so its drops fall elsewhere and change the "
                f"hidden states that later layers attend to" if cfg.n_experts else
                "bf16 alone at the served depth (reported, not held): the float32 model of the whole depth would not "
                "fit the card")
        emit(f"{arch_group(cfg)}.decode_vs_full_forward.served", arch=cfg.name, depth=cfg.n_layers, batch=list(bs),
             errors=res, note=f"{note}; LM_RULE is held at depth {cut32}")
    del full16


def decode_rule_at_cut(arch, cut, dev):
    """lm.moe / lm.embed.decode_vs_full_forward: LM_RULE on ``arch`` at full width, depth cut to ``cut``.

    The bf16 model serves LM_BATCHES and takes its full forwards, and is
    freed; then a float32 model of the same draws, rounded through bf16
    wherever the bf16 model holds bf16 (its MoE routers are float32 in
    both), serves the same tokens.  A float32 copy beside the bf16 model
    would not fit: arctic's one layer is 56 GB in float32.
    """
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.train import serve_step

    torch.cuda.empty_cache()
    kw = {"n_layers": cut}
    if configs.get_config(arch).n_experts:
        kw["capacity_factor"] = LM_ARCH_RULE_CF
    cfg, model = lm_model(arch, dev, **kw)
    prompts = arch_prompts(cfg, dev)
    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    runs = {}
    for bs in LM_BATCHES:
        with moe.recording() as rec:
            runs[bs] = serve(prefill, decode, model, prompts[bs], LM_STEPS)
        runs[bs]["routes"] = rec
    routes = {}
    full16 = full_forwards(model, cfg, prompts, runs, routes)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    probe = {n: p.detach()[:2].float().clone() for n, p in model.named_parameters() if p.ndim >= 2}
    del model
    torch.cuda.empty_cache()
    cfg32, model32 = lm_model(arch, dev, param_dtype="float32", activation_dtype="float32", **kw)
    with torch.no_grad():
        for n, p in model32.named_parameters():
            if dtypes[n] != torch.float32:
                for part in p.view(-1).split(1 << 26):  # in slices: arctic's expert leaf is 17.9 GB in float32
                    part.copy_(part.to(dtypes[n]).float())
    same = all(torch.equal(dict(model32.named_parameters())[n][:2], t) for n, t in probe.items())
    check(same, f"{arch}: the float32 model's draws are not the bf16 model's")
    hold_decode_to_f32(f"{arch_group(cfg)}.decode_vs_full_forward", model32, cfg32, prompts, runs, full16,
                       note=f"full width, depth cut to {cut} so that the float32 model fits beside nothing else; "
                       "the float32 weights are the bf16 model's draws (checked on each matrix's first rows)"
                       + (f"; capacity factor {LM_ARCH_RULE_CF} (the served cell: {configs.get_config(arch).capacity_factor}) "
                          "so that the compared tokens' choices are not dropped; a row is held where every run routes "
                          "its token alike (the same experts in every layer, every choice kept)"
                          if cfg.n_experts else ""),
                       routes16=routes if cfg.n_experts else None)
    del model32, full16
    torch.cuda.empty_cache()


def profile_lm_moe(model, cfg, prompts, dev):
    """profile.lm.moe: one 4 x 2048 prefill under torch.profiler (top kernels, idle share), and the MoE's parts by
    CUDA events at a layer's prefill shapes (layer 0's weights, seeded normal input), times the layers."""
    from repro_torch.models import moe
    from repro_torch.models.layers import _gelu_tanh
    from repro_torch.train import serve_step

    prefill = serve_step.make_prefill_step(cfg)[0]
    b, s = LM_BATCHES[0]
    rows, busy, wall = profile_call("profile.lm.moe", f"prefill {b} x {s}, {cfg.name} bf16 at depth {cfg.n_layers}",
                                    lambda: prefill(model, prompts[(b, s)], cache_len=s + 1))
    p = model.layers[0].moe
    e, k, g, d = cfg.n_experts, cfg.experts_per_token, moe.group_size(b * s, cfg), cfg.d_model
    cap, n_g = moe.capacity(g, cfg), b * s // g
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(n_g, g, d, generator=gen, device=dev).to(torch.bfloat16)
    gate, idx, _, keep, dest = moe.route(p, x, cfg)
    grp = torch.arange(n_g, device=dev)[:, None]

    def router():
        torch.topk(torch.softmax(x.float() @ p.router, -1), k, dim=-1)

    def table():
        t = torch.full((n_g, e * cap + 1), g, dtype=torch.long, device=dev)
        ids = torch.arange(g, device=dev)[None, :, None].expand(dest.shape)
        return t.scatter_(1, dest.reshape(n_g, -1), ids.reshape(n_g, -1))[:, :e * cap]

    tab = table()
    x_pad = torch.cat([x, x.new_zeros((n_g, 1, d))], 1)

    def dispatch():
        return x_pad[grp, tab].reshape(n_g, e, cap, d).transpose(0, 1).reshape(e, n_g * cap, d)

    xin = dispatch()
    act = torch.nn.functional.silu if cfg.mlp == "swiglu" else _gelu_tanh

    def experts():
        return torch.bmm(act(torch.bmm(xin, p.w_gate)) * torch.bmm(xin, p.w_up), p.w_down)

    out = experts().reshape(e, n_g, cap, d).transpose(0, 1).reshape(n_g, e * cap, d)
    out = torch.cat([out, out.new_zeros((n_g, 1, d))], 1)

    def combine():
        return torch.einsum("gtkd,gtk->gtd", out[grp[..., None], dest], (gate * keep).to(x.dtype))

    parts = {"router_topk_ms": cuda_ms(router, 5)}
    parts["tables_ms"] = cuda_ms(lambda: moe.route(p, x, cfg), 5) - parts["router_topk_ms"] + cuda_ms(table, 5)
    parts["dispatch_gather_ms"] = cuda_ms(dispatch, 5)
    parts["expert_gemms_ms"] = cuda_ms(experts, 5)
    parts["combine_ms"] = cuda_ms(combine, 5)
    whole = cuda_ms(lambda: moe.route_groups(p, x, cfg), 5)
    flops = 2 * 3 * e * n_g * cap * d * cfg.moe_d_ff
    useful = 2 * 3 * b * s * k * d * cfg.moe_d_ff
    emit("profile.lm.moe.parts", arch=cfg.name, groups=[n_g, g], capacity=cap, parts=parts, route_groups_ms=whole,
         parts_sum_ms=sum(parts.values()), layers=cfg.n_layers, moe_ms_summed=whole * cfg.n_layers,
         moe_share_of_busy=whole * cfg.n_layers / busy if busy else "not measured",
         expert_gemm_tflops=flops / parts["expert_gemms_ms"] / 1e9,
         expert_rows_computed_over_routed=flops / useful,
         note="CUDA events outside the profiler at a layer's prefill shapes (seeded normal input, layer 0's weights), "
         "times the layers; tables = positions and slots (route minus the router) plus the token table's scatter; "
         "the expert GEMMs run E x capacity rows, of which k x tokens at most hold a token")
    del x, xin, out
    torch.cuda.empty_cache()


def phase_lm_moe_grad(dev):
    """lm.moe.grad: one qwen3-moe block at full width (64 query heads, the float32 router and 128 experts), float32,
    in train mode on 1 x LM_GRAD_S seeded normal inputs: d(sum(out * c)) on the card against the CPU, each parameter
    and the input, under LM_GRAD_RULE's float32 part, with the routing of each (token, choice) compared."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config("qwen3-moe-235b-a22b"), n_layers=1, param_dtype="float32",
                              activation_dtype="float32")
    blk = tf._init_block_(tf.Block("global", cfg, torch.float32, dev), torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 2)
    x, cot = (torch.randn(1, LM_GRAD_S, cfg.d_model, generator=gen) for _ in range(2))
    pos = torch.arange(LM_GRAD_S)[None]

    def grads(block, on):
        named = dict(block.named_parameters())
        for t in named.values():
            t.requires_grad_(True)
        xx = x.to(on).requires_grad_(True)
        with moe.recording() as rec:
            out = tf.apply_block(block, "global", xx, pos.to(on), cfg, mode="train")[0]
        g = torch.autograd.grad(torch.sum(out * cot.to(on)), [*named.values(), xx])
        return dict(zip([*named, "x"], g)), rec[0]

    t_cpu = time.perf_counter()
    g_cpu, r_cpu = grads(copy.deepcopy(blk).cpu(), "cpu")
    t_cpu = time.perf_counter() - t_cpu
    ops.reset_launch_counts()
    g_card, r_card = grads(blk, dev)
    launches = ops.launch_counts()
    flips = int((r_card["expert"].cpu() != r_cpu["expert"]).sum())
    kept_flips = int((r_card["kept"].cpu() != r_cpu["kept"]).sum())
    rows, bad = {}, []
    for n, gc in g_cpu.items():
        tol = 1e-4 * float(gc.abs().max()) + 1e-6
        rows[n] = dict(f32_abs_err=max_err(g_card[n].cpu(), gc), f32_tol=tol)
        if rows[n]["f32_abs_err"] > tol:
            bad.append(n)
    emit("lm.moe.grad", arch=cfg.name, config=f"{cfg.source}; one global-attention block at full width (QK-norm, the "
         f"MoE: {cfg.n_experts} experts, top {cfg.experts_per_token}, ff {cfg.moe_d_ff})",
         reduced=["one block, no embedding or head"], tokens=[1, LM_GRAD_S], capacity=moe.capacity(LM_GRAD_S, cfg),
         routing_flips=flips, keep_flips=kept_flips, dropped_card=int((~r_card["kept"]).sum()),
         dropped_cpu=int((~r_cpu["kept"]).sum()), launches=launches,
         worst=max(r["f32_abs_err"] for r in rows.values()), by_param=rows,
         rule="LM_GRAD_RULE's float32 part: " + LM_GRAD_RULE.split(";")[0] + "; 0 routing flips",
         cpu_seconds=t_cpu, seconds=time.perf_counter() - t0,
         note="loss sum(block(x) * c), c seeded normal; the router's product in IEEE float32 on the card "
         "(core.gp.ieee_float32_matmul); the dispatch gather's backward is a scatter-add (atomics on the card)")
    check(launches == {**NO_LAUNCHES, "flash_attention": 1}, f"lm.moe.grad: launches {launches}, not one flash")
    check(flips == 0 and kept_flips == 0, f"lm.moe.grad: {flips} routing and {kept_flips} keep flips, card against CPU")
    check(not bad, f"lm.moe.grad: gradients outside the rule: {[(n, rows[n]) for n in bad]}")
    del blk, g_card
    torch.cuda.empty_cache()


def phase_lm_arch(dev):
    """The MoE and embeddings-input group: each of LM_ARCH_CELLS served (and decode held to LM_RULE), qwen3-moe
    profiled, LM_ARCH_TRAIN trained, the gradients checked; lm.arch.total against LM_ARCH_BUDGET_S (the profile not
    counted).  Returns the launches by path."""
    from repro_torch import configs

    t_all = time.perf_counter()
    seconds, launches = 0.0, {}
    for arch, (cut, cut32) in LM_ARCH_CELLS.items():
        t = time.perf_counter()
        total, model, cfg, prompts, runs = serve_cell(arch, cut, dev)
        group = arch_group(cfg)
        launches[group] = {k: launches.get(group, NO_LAUNCHES)[k] + total[k] for k in NO_LAUNCHES}
        if cut32 is None:
            decode_vs_full_forward(f"{group}.decode_vs_full_forward", model, cfg, prompts, runs)
        else:
            served_decode_gaps(model, cfg, prompts, runs, cut32)
        seconds += time.perf_counter() - t
        if arch == "qwen3-moe-235b-a22b":
            profile_lm_moe(model, cfg, prompts, dev)
        del model, prompts, runs
        torch.cuda.empty_cache()
        if cut32 is not None:
            t = time.perf_counter()
            decode_rule_at_cut(arch, cut32, dev)
            seconds += time.perf_counter() - t
    t = time.perf_counter()
    for arch, cut in LM_ARCH_TRAIN.items():
        group = arch_group(configs.get_config(arch))
        launches[f"{group}.train"] = phase_lm_cell_train(f"{group}.train", arch, dev, cut)
    emit("lm.arch.not_trained", reason=LM_ARCH_NOT_TRAINED)
    phase_lm_moe_grad(dev)
    phase_lm_cell_grad("lm.embed.grad", "musicgen-large", LM_ARCH_GRAD_CUT, dev)
    seconds += time.perf_counter() - t
    emit("lm.arch.total", seconds=seconds, budget_s=LM_ARCH_BUDGET_S, wall_seconds=time.perf_counter() - t_all,
         note="lm.moe.* and lm.embed.* (serve, decode_vs_full_forward, train, grad) by the script's clock; "
         "profile.lm.moe not counted")
    check(seconds <= LM_ARCH_BUDGET_S, f"the MoE and embeddings phases took {seconds} s of {LM_ARCH_BUDGET_S}")
    return launches


RANK_JOBS = {"dist": dist_job, "fleet_sharded": fleet_sharded_job, "lm_mesh": lm_mesh_job}


# ---------------------------------------------------------------------------
# The launch tools: the dry-run on fake production worlds, its count held against the card
# ---------------------------------------------------------------------------

LAUNCH_BUDGET_S = 90.0        # the launch phases' share of the script's wall time
LAUNCH_PEAK_RTOL = 0.15       # the dry-run's peak bytes against torch.cuda.max_memory_allocated
LAUNCH_PREFILL = (4, 2048)    # launch.card: gemma2-2b's prefill as lm.serve runs it (B, S)
LAUNCH_TRAIN = (2, 2048)      # and an Adam step as lm.train runs it
LAUNCH_JOIN_S = 600.0         # a dry-run process that outlives this fails the phase


def launch_dryrun_job(multi: bool, out_dir: str) -> None:
    """A spawned process, rank 0 of a fake world: the (2, 16, 16) mesh's gp_512k (``multi``), or the (16, 16)
    mesh's gemma2-2b train_4k, prefill_32k and decode_32k and gp_256k, then gp_dist_32k on a fake 2 x 2 mesh (the
    cell dist.predict runs on the card), whose counts go to ``dist22.out``.  Records go to ``out_dir``."""
    import os

    sys.path.insert(0, str(SRC))
    sys.stdout = open(os.devnull, "w")  # the cells' progress lines; the parent reports the records
    from repro_torch import configs
    from repro_torch.configs import gp_msd
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch.mesh import make_test_mesh

    if multi:
        dryrun.run_gp_cell(gp_msd.GP_DIST_512K, True, out_dir, probes=False, force=True)
        return
    for shape in configs.shapes_for(LM_ARCH):
        dryrun.run_lm_cell(LM_ARCH, shape, False, out_dir, probes=False, force=True)
    dryrun.run_gp_cell(gp_msd.GP_DIST_256K, False, out_dir, probes=False, force=True)
    mesh = make_test_mesh(DIST_GRID, ("data", "model"), device_type="cpu")
    fn, *args = dryrun.gp_predict(gp_msd.GP_DIST_32K, mesh, ("data",), ("model",), d_feat=N_FEATURES)
    with analysis.measure() as m:
        fn(*args)
    with open(os.path.join(out_dir, "dist22.out"), "w") as f:
        json.dump({"collectives": m.collectives.as_record(), "launches": m.launches}, f)


def card_vs_meta(name, fn, real_calls, meta_args, base, hw):
    """One step on the card against the same step on meta tensors: ``real_calls`` are three argument tuples (a
    warm call, the timed call whose peak memory is read, the counted call).  Returns the phase's fields."""
    from repro_torch.launch import analysis

    with analysis.measure(resident=meta_args) as meta:
        fn(*meta_args)
    fn(*real_calls[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, seconds = wall_s(lambda: fn(*real_calls[1]))
    peak = torch.cuda.max_memory_allocated() - base
    with analysis.measure(resident=real_calls[2]) as card:
        fn(*real_calls[2])
        torch.cuda.synchronize()
    cost = analysis.cost_summary(meta)
    terms = {"compute_s": hw.compute_seconds(cost["flops"], "bfloat16"), "memory_s": hw.memory_seconds(cost["bytes"]),
             "collective_s": 0.0}
    out = dict(flops_meta=meta.flops, flops_card=card.flops, launches_meta=meta.launches, launches_card=card.launches,
               launched_card=card.launched,
               bytes_meta=meta.bytes, bytes_card=card.bytes, peak_bytes_estimate=meta.peak_bytes,
               max_memory_allocated=peak, peak_ratio=meta.peak_bytes / peak, seconds=seconds, **terms,
               dominant=max(terms, key=terms.get),
               measured_over={k: seconds / v for k, v in terms.items() if v},
               meta_run_s=meta.seconds)
    check(meta.flops == card.flops, f"launch.card.{name}: FLOPs on the card {card.flops} != the meta run's "
          f"{meta.flops}")
    check(meta.launches == card.launches == card.launched and not meta.launched,
          f"launch.card.{name}: launches counted on meta {meta.launches}, counted on the card {card.launches}, "
          f"launched on the card {card.launched}, launched on meta {meta.launched}")
    check(abs(meta.peak_bytes / peak - 1) <= LAUNCH_PEAK_RTOL, f"launch.card.{name}: peak estimate "
          f"{meta.peak_bytes} against max_memory_allocated {peak}: off by more than {LAUNCH_PEAK_RTOL}")
    check(seconds >= terms["compute_s"], f"launch.card.{name}: {seconds} s is under the compute term "
          f"{terms['compute_s']} s")
    return out


def phase_launch_card(dev, smi):
    """launch.card: gemma2-2b at full width, bf16, on the card at world 1 (a 4 x 2048 prefill, a 2 x 2048 Adam step,
    as lm.serve and lm.train run them) against the dry-run's count of the same step on meta tensors."""
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import H100_SXM
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adam, cosine_warmup
    from repro_torch.train import make_train_step, serve_step

    cfg = configs.get_config(LM_ARCH)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = tf.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    meta_model = specs.params_shape(cfg)
    rng = np.random.default_rng(SEED)
    b, s = LAUNCH_PREFILL
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev) for _ in range(3)]
    prefill, _ = serve_step.make_prefill_step(cfg)

    def run_prefill(m, x):
        prefill(m, x)  # the logits and caches are dropped at once

    fields = {"prefill": card_vs_meta("prefill", run_prefill, [(model, x) for x in prompts],
                                      (meta_model, torch.empty_like(prompts[0], device="meta")), base, H100_SXM)}
    opt = Adam(learning_rate=cosine_warmup(3e-4, 1, 100))
    step, _ = make_train_step(cfg, opt)
    state = opt.init(model)
    batches = lm_batch(cfg, *LAUNCH_TRAIN, SEED, dev, 3)

    def run_step(m, st, x, y):
        step(m, st, x, y)

    meta_batch = tuple(torch.empty_like(t, device="meta") for t in batches[0])
    fields["train"] = card_vs_meta("train", run_step, [(model, state, *bt) for bt in batches],
                                   (meta_model, opt.init(meta_model), *meta_batch), base, H100_SXM)
    del model, state, batches, prompts
    torch.cuda.empty_cache()
    emit("launch.card", arch=LM_ARCH, config="src/repro/configs/gemma2_2b.py, full width, bf16, seeded, world 1",
         prefill_shape=[b, s], train_shape=list(LAUNCH_TRAIN), optimizer="Adam(cosine_warmup(3e-4, 1, 100))", card=smi,
         hardware="H100_SXM: 989 TFLOP/s bf16, 3.35 TB/s, 50 GB/s a GPU (published peaks)", **fields,
         rule=f"FLOPs equal; the launches counted on meta, counted on the card and launched on the card equal; the peak estimate within {LAUNCH_PEAK_RTOL} of max_memory_allocated "
         "(less the bytes held before the model); the measured seconds at least the compute term; no bar on the "
         "memory term (unfused bytes, which the 50 MB L2 can beat)")


def phase_launch(dev):
    """launch.dryrun (two spawned processes, a fake world each) beside launch.card on the card; launch.dist: the
    dry-run's gp_dist_32k on a fake 2 x 2 mesh against dist.predict's rank 0; launch.total against its budget."""
    import multiprocessing
    import shutil
    import tempfile

    from repro_torch.core import distributed as dgp
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import H100_SXM

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=launch_dryrun_job, args=(multi, out_dir)) for multi in (False, True)]
    for p in procs:
        p.start()
    try:
        phase_launch_card(dev, smi)
        for p in procs:
            p.join(timeout=max(1.0, LAUNCH_JOIN_S - (time.perf_counter() - t0)))
            if p.is_alive():
                p.kill()
                p.join()
        t_dry = time.perf_counter() - t0
        check(all(p.exitcode == 0 for p in procs), f"launch.dryrun: exit codes {[p.exitcode for p in procs]}")
        records = roofline.load_records(out_dir)
        rows = []
        for rec in records:
            row = roofline.derive(rec, H100_SXM)
            full = rec.get("full", {})
            rows.append(dict(cell=row["cell"], mesh=row["mesh"], ok=rec["ok"], error=rec.get("error"),
                             devices=rec.get("devices"), flops_per_rank=full.get("cost", {}).get("flops"),
                             bytes_per_rank=full.get("cost", {}).get("bytes"),
                             wire_bytes_per_rank=full.get("collectives", {}).get("total_wire_bytes"),
                             peak_bytes=full.get("memory", {}).get("peak_bytes"), fits_80gb=rec.get("fits_80gb"),
                             compute_s=row["compute_s"], memory_s=row["memory_s"], collective_s=row["collective_s"],
                             dominant=row["dominant"], launches=full.get("cost", {}).get("launches"),
                             meta_run_s=rec.get("times", {}).get("meta_run_s")))
        emit("launch.dryrun", cells=rows, seconds=t_dry, card=smi,
             note="rank 0 of a fake world of 256 ((16, 16)) or 512 ((2, 16, 16)) ranks on meta tensors; terms on "
             "H100_SXM's published peaks (bf16 LM, FP32 GP), bytes unfused")
        check(len(rows) == 5 and all(r["ok"] for r in rows), f"launch.dryrun: {[(r['cell'], r['error']) for r in rows]}")
        with open(Path(out_dir) / "dist22.out") as f:
            dry = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    from repro_torch.configs.gp_msd import GP_DIST_32K

    want = DIST_COUNTS.get("collectives")
    sched = dgp.schedule_launches(GP_DIST_32K.m_tiles, *DIST_GRID, 0, 0, predict=True)
    emit("launch.dist", dryrun=dry, card_rank0=DIST_COUNTS, schedule=sched,
         note="gp_dist_32k on a 2 x 2 mesh: the dry-run (fake world, meta tensors) against dist.predict's rank 0 on "
         "the card; calls and bytes by op equal, the dry-run's counted launches equal to the schedule's and to rank 0's "
         "launches on the card")
    check(want is not None and dry["collectives"]["ops"] == want["ops"]
          and dry["collectives"]["operand_bytes"] == want["operand_bytes"]
          and dry["collectives"]["wire_bytes"] == want["wire_bytes"],
          f"launch.dist: collectives {dry['collectives']} != dist.predict's {want}")
    check(dry["launches"] == sched == {k: DIST_COUNTS.get("launches", {}).get(k) for k in sched},
          f"launch.dist: launches {dry['launches']} / {DIST_COUNTS.get('launches')} != the schedule's {sched}")
    seconds = time.perf_counter() - t0
    emit("launch.total", seconds=seconds, budget_s=LAUNCH_BUDGET_S, card=smi,
         note="launch.card on the card beside the two dry-run processes, then launch.dist")
    check(seconds <= LAUNCH_BUDGET_S, f"the launch phases took {seconds} s of {LAUNCH_BUDGET_S}")


# ---------------------------------------------------------------------------
# The examples: the five entry points a user runs (examples_torch/), on the card
# ---------------------------------------------------------------------------

EXAMPLES_BUDGET_S = 120.0     # the examples phases' share of the script's wall time
EXAMPLES_SYSID = dict(n=N_TRAIN, n_test=512, tile=TILE)  # gp_16k's n and tile; the example's default n_test
# serve_gp's modes at its docstring's sizes (examples/serve_gp.py:31-34); the ragged run also writes --metrics
EXAMPLES_SERVE = {"single": dict(), "fleet": dict(fleet=8, n=512), "online": dict(online=True, n=1024, arrive=32),
                  "ragged": dict(ragged=12, n=512, tile=64)}
EXAMPLES_LM = dict(arch="olmo-1b", size="full", steps=3, batch=8, seq=128)
# the resume: train_lm.py at --size 100m killed after its log line at step 10, then the same command again
EXAMPLES_RESUME = dict(arch="olmo-1b", size="100m", steps=12, ckpt_every=4)
EXAMPLES_KILL_AT = 10
EXAMPLES_PARAM_RTOL = 2e-2    # trained hyperparameters, card against CPU (the train phase's parameter rule)
EXAMPLES_RESUME_RTOL = 1e-5   # PERF.md section 2's resume rule


def example_modules():
    sys.path.insert(0, str(ROOT))
    from examples_torch import composite_workload, gp_system_identification, quickstart, serve_gp, train_lm

    return quickstart, gp_system_identification, serve_gp, composite_workload, train_lm


def start_killed_train_lm(ckpt_dir, dev):
    """``examples_torch/train_lm.py`` at EXAMPLES_RESUME as a user starts it, killed (SIGKILL) after its log line at
    step EXAMPLES_KILL_AT; returns (process, watcher thread, the lines it printed)."""
    import os
    import signal
    import threading

    r = EXAMPLES_RESUME
    cmd = [sys.executable, "-u", str(ROOT / "examples_torch" / "train_lm.py"), "--arch", r["arch"], "--size",
           r["size"], "--steps", str(r["steps"]), "--ckpt-every", str(r["ckpt_every"]), "--ckpt-dir", ckpt_dir,
           "--device", str(dev)]
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []

    def watch():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith(f"[trainer] step {EXAMPLES_KILL_AT}/"):
                proc.send_signal(signal.SIGKILL)
                break
        proc.stdout.close()

    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    return proc, thread, lines


def gp_accuracy(phase, mean, var, x_train, y_train, x_test, dev, kernel=None):
    """PERF.md section 2's GP accuracy rule: (fields, ok) of ``mean``/``var`` against a float64 dense solve, the
    bound from the float32 dense pipeline's error on the same inputs."""
    from repro_torch.core import GaussianProcess

    mean_ref, var_ref = dense_reference(x_train, y_train, x_test, dev, kernel=kernel)
    mono = GaussianProcess(x_train, y_train, pipeline="monolithic", kernel=kernel, device=dev)
    mean_d, var_d = mono.predict_with_uncertainty(x_test)
    e, dense, mean_bound, var_bound = accuracy_bounds(mean_ref, var_ref, mean_d, var_d)
    out = dict(mean_err=e(mean, mean_ref), var_err=e(var, var_ref), mean_bound=mean_bound, var_bound=var_bound,
               **dense)
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), f"{phase}: non-finite predictions")
    return out, out["mean_err"] <= mean_bound and out["var_err"] <= var_bound


def _leaves(params):
    from repro_torch.core import kernels_math as km

    return [float(v) for v in km.tree_leaves(params)]


def phase_examples(dev, smi):
    """The five examples through their own functions, as their command lines run them; launches by example.

    examples.gp_system_identification at gp_16k on the MSD data, examples.quickstart and
    examples.composite_workload at their defaults (trained parameters against the same run on the CPU),
    examples.serve_gp in four modes, examples.train_lm (olmo-1b at full width; a killed and rerun command line
    at --size 100m against an uninterrupted run), examples.total against EXAMPLES_BUDGET_S.
    """
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import Matern52, Scaled, Sum, White
    from repro_torch.core import predict as pred
    from repro_torch.core.gp import ieee_float32_matmul
    from repro_torch.data.msd import MSDConfig, make_dataset
    from repro_torch.kernels import ops

    quickstart, sysid, serve_gp, composite, train_lm = example_modules()
    t0 = time.perf_counter()
    launches, by_example = dict(NO_LAUNCHES), {}

    def counted(name, fn):
        ops.reset_launch_counts()
        out, seconds = wall_s(fn)
        by_example[name] = ops.launch_counts()
        for k, v in by_example[name].items():
            launches[k] = launches.get(k, 0) + v
        return out, seconds

    tmp = tempfile.mkdtemp(prefix="examples_")
    try:
        # the command line to be killed runs while this process makes the MSD data (host work)
        ckpt = str(Path(tmp) / "ckpt")
        proc, watcher, child_lines = start_killed_train_lm(ckpt, dev)
        s = EXAMPLES_SYSID
        data, t_data = wall_s(lambda: make_dataset(s["n"], s["n_test"], MSDConfig(), seed=0))
        watcher.join(timeout=300)
        proc.wait(timeout=60)
        killed_rc = proc.returncode

        # the paper's use case at gp_16k
        log = []
        out, seconds = counted("gp_system_identification", lambda: sysid.run(dev, data=data, log=log.append, **s))
        acc, ok = gp_accuracy("examples.gp_system_identification", out["mean"], out["var"], *data[:3], dev)
        mono_bound = acc["mean_bound"] + acc["mean_err_dense_f32"]
        emit("examples.gp_system_identification", config="gp_16k (src/repro/configs/gp_msd.py:11) on the MSD "
             "data (repro_torch.data.msd.make_dataset, seed 0)", **s, printed=log, seconds=seconds,
             data_seconds=t_data, predict_seconds=out["seconds"], r2=out["r2"], coverage=out["coverage"],
             max_tiled_vs_monolithic=out["max_tiled_vs_monolithic"], tiled_vs_monolithic_bound=mono_bound,
             launches=by_example["gp_system_identification"], **acc, card=smi, rule=BOUND_RULE)
        check(ok, f"examples.gp_system_identification: errors {acc} above the rule's bounds")
        check(out["max_tiled_vs_monolithic"] <= mono_bound, f"examples.gp_system_identification: tiled against "
              f"monolithic {out['max_tiled_vs_monolithic']} above {mono_bound}")
        del data, out

        # quickstart and composite_workload at their defaults, trained parameters against the CPU's
        for name, mod, kernel, cpu_kw in (("quickstart", quickstart, None, dict(n_big=512)),
                                          ("composite_workload", composite, Sum(Scaled(Matern52()), White()), {})):
            log = []
            out, seconds = counted(name, lambda: mod.run(dev, log=log.append))
            acc, ok = gp_accuracy(f"examples.{name}", out["mean"], out["var"], out["x_train"], out["y_train"],
                                  out["x_test"], dev, kernel=kernel)
            cpu, t_cpu = wall_s(lambda: mod.run("cpu", log=[].append, **cpu_kw))
            got, want = _leaves(out["params"]), _leaves(cpu["params"])
            extra = {k: out[k] for k in ("warm", "cold", "dispatches", "health", "cache_stats") if k in out}
            emit(f"examples.{name}", printed=log, seconds=seconds, build_seconds=out["build_s"],
                 launches=by_example[name], untrained=acc, params=got, params_cpu=want, cpu_seconds=t_cpu,
                 cpu_run=cpu_kw or "the same defaults", **extra, card=smi,
                 rule=f"untrained mean and variance: {BOUND_RULE}; trained parameters within rtol "
                      f"{EXAMPLES_PARAM_RTOL} of the same run on the CPU")
            check(ok, f"examples.{name}: untrained errors {acc} above the rule's bounds")
            check(_rel_close(got, want, EXAMPLES_PARAM_RTOL), f"examples.{name}: trained params {got} against the "
                  f"CPU's {want}")
            del out, cpu

        # serve_gp in its four modes; each mode's served predictions of one batch against a synchronous call
        metrics = str(Path(tmp) / "metrics.jsonl")
        for mode, kw in EXAMPLES_SERVE.items():
            log = []
            kw = dict(kw, metrics=metrics) if mode == "ragged" else kw
            out, seconds = counted(f"serve_gp.{mode}", lambda: serve_gp.run(dev, log=log.append, **kw))
            if mode == "single":
                same = torch.equal(out["served"], out["gp"].predict(out["probe"]))
            elif mode == "fleet":
                same = torch.equal(out["served"], out["fleet"].predict(out["probe"]))
            elif mode == "online":
                gp = out["gp"]
                with ieee_float32_matmul(dev):
                    same = torch.equal(gp.predict(out["probe"]), pred.predict_from_state(gp.posterior(), out["probe"]))
            else:
                probes = [out["probe"][i] for i in sorted(out["probe"])]
                again = out["fleet"].predict_each(probes)
                same = all(torch.equal(out["served"][i], again[i].cpu()) for i in sorted(out["probe"]))
            fields = {k: v for k, v in out.items() if isinstance(v, (int, float, str, list, dict))
                      and k not in ("latencies_s", "probe", "served", "sizes")}
            if mode == "ragged":
                with open(metrics) as f:
                    fields["metrics_lines"] = sum(1 for _ in f)
            emit(f"examples.serve_gp.{mode}", args=kw, printed=log, seconds=seconds, **fields,
                 launches=by_example[f"serve_gp.{mode}"], bitwise_vs_synchronous=same, card=smi,
                 note="latencies on the host clock, each batch ending in torch.cuda.synchronize(); the first batch "
                      "dropped, as the example drops it")
            check(same, f"examples.serve_gp.{mode}: served predictions differ from a synchronous call on the state")
            if mode == "ragged":
                check(fields["metrics_lines"] > 0, "examples.serve_gp.ragged: no telemetry written")
            del out
            torch.cuda.empty_cache()

        # train_lm: olmo-1b at full width, then the killed command line rerun against an uninterrupted run
        log = []
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lm = EXAMPLES_LM
        out, seconds = counted("train_lm", lambda: train_lm.run(lm["arch"], lm["size"], device=dev, log=log.append,
                                                                **{k: lm[k] for k in ("steps", "batch", "seq")}))
        peak = torch.cuda.max_memory_allocated() - base
        losses, median = out["losses"], out["median_step_s"]
        del out
        torch.cuda.empty_cache()
        emit("examples.train_lm", args=lm, printed=log, seconds=seconds, losses=losses, median_step_s=median,
             peak_memory_gib=peak / 2**30, launches=by_example["train_lm"], card=smi)
        check(len(losses) == lm["steps"] and all(math.isfinite(v) for v in losses),
              f"examples.train_lm: losses {losses}")
        saved = CheckpointManager(ckpt).latest_step()
        r = EXAMPLES_RESUME
        kw = dict(steps=r["steps"], device=dev, log=[].append)
        again, t_again = wall_s(lambda: train_lm.run(r["arch"], r["size"], ckpt_dir=ckpt,
                                                     ckpt_every=r["ckpt_every"], **kw))
        whole, t_whole = wall_s(lambda: train_lm.run(r["arch"], r["size"], **kw))
        k = r["steps"] - (saved or 0)
        got, want = again["losses"][:k], whole["losses"][saved or 0:]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        emit("examples.train_lm.resume", args=dict(r, ckpt_dir="<tmp>"), killed_at_log_of_step=EXAMPLES_KILL_AT,
             killed_returncode=killed_rc, killed_printed=child_lines, last_saved=saved,
             resumed_from=again["resumed_from"], resumed_losses=got, uninterrupted_losses=want, rel_diff=rel,
             bitwise=got == want, seconds={"rerun": t_again, "uninterrupted": t_whole}, card=smi,
             rule=f"resumed from the last saved step; its losses within {EXAMPLES_RESUME_RTOL} relative of the "
                  "uninterrupted run's at the same steps")
        check(killed_rc == -9 and saved is not None, f"examples.train_lm.resume: the command line ended with "
              f"{killed_rc}, last checkpoint {saved}: {child_lines[-5:]}")
        check(again["resumed_from"] == saved, f"examples.train_lm.resume: resumed from {again['resumed_from']}, "
              f"not {saved}")
        check(len(got) == k and all(v <= EXAMPLES_RESUME_RTOL for v in rel),
              f"examples.train_lm.resume: resumed losses {got} against {want}")
        del again, whole
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    emit("examples.total", seconds=seconds, budget_s=EXAMPLES_BUDGET_S, launches=launches, by_example=by_example,
         card=smi, note="the examples' functions with their default or documented arguments, the checks' CPU runs "
         "and float64 references included")
    check(seconds <= EXAMPLES_BUDGET_S, f"the examples took {seconds} s of {EXAMPLES_BUDGET_S}")
    return launches


def phase_train_kinv(x_train, y_train, dev, smi):
    """train.kinv: K^-1 of gp_16k's first matern52 training step (paper-default params) by the reference's route,
    ``triangular.kinv_tiles_from_factor`` (a tiled matrix solve on identity tiles, then the tiled gram), beside the
    port's ``torch.cholesky_inverse`` of the unpacked factor: each route's time, its error against a float64
    ``cholesky_inverse`` of the same factor, and the gradient the blocked rule takes from it, each component
    against float64 dense autograd.  Neither route is chosen here."""
    from repro_torch.core import mll, tiling, triangular
    from repro_torch.core import kernels_math as km
    from repro_torch.kernels import ops

    kern = km.Matern52()
    p0 = km.SEKernelParams.paper_defaults()
    cfg = mll._Config(TILE, None, None, torch.float32, kern, dev)
    x, y = (torch.as_tensor(a, device=dev) for a in (x_train, y_train))
    n = y.shape[0]
    torch.cuda.empty_cache()
    _, (lpacked, alpha_c) = mll._nlml_forward(cfg, x, y, p0)
    routes = {
        "kinv_tiles_from_factor": lambda: tiling.untile_dense(triangular.kinv_tiles_from_factor(lpacked))[:n, :n],
        "cholesky_inverse": lambda: torch.cholesky_inverse(tiling.unpack_lower(lpacked)[:n, :n]),
    }
    k64 = torch.cholesky_inverse(tiling.unpack_lower(lpacked).double()[:n, :n])
    names = ["lengthscale", "vertical", "noise"]
    (v64, g64), (vd, gd) = [value_and_grads(lambda p, d_: mll.negative_log_marginal_likelihood(
        x_train, y_train, p, dtype=d_, kernel=kern, device=dev), p0, dt, dev) for dt in (torch.float64, torch.float32)]
    torch.cuda.empty_cache()
    res = {}
    for name, fn in routes.items():
        ops.reset_launch_counts()
        kinv = fn()
        launched = ops.launch_counts()
        ms = cuda_ms(fn, reps=3)
        err = max_err(kinv, k64)
        g = mll._nlml_dense_grads(kern, mll._cast(p0, torch.float32, dev), x, alpha_c.reshape(-1)[:n], kinv)[2]
        g = [float(v) for v in km.tree_leaves(g)]
        del kinv
        torch.cuda.empty_cache()
        errs, bnd, ok = grad_rule(g, g64, gd, 1e-3)
        res[name] = dict(ms=ms, max_abs_err_vs_float64=err, max_abs_float64=float(k64.abs().max()), grad=g,
                         grad_abs_err=errs, grad_rel_err=[e / abs(b) for e, b in zip(errs, g64)], grad_bound=bnd,
                         meets_grad_rule=ok, launches=launched)
        check(math.isfinite(err) and all(math.isfinite(v) for v in g), f"train.kinv: {name} is not finite")
    del k64
    torch.cuda.empty_cache()
    emit("train.kinv", config="gp_16k", kernel="matern52", params=dict(zip(names, _leaves(p0))), n=n, tile=TILE,
         routes=res, grad_float64_dense=dict(zip(names, g64)), grad_float32_dense=dict(zip(names, gd)),
         vertical_rel_err={k: r["grad_rel_err"][1] for k, r in res.items()}, card=smi,
         rule=GRAD_RULE.format("1e-3") + "; reported for both routes, neither required to win",
         note="ms: CUDA events over 3 calls after one warm call, unpacking or untiling included; the gradient is "
              "mll._nlml_dense_grads with each route's K^-1; the training backward takes cholesky_inverse")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the root of a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    if sys.argv[1:] == ["--only-examples"]:  # the examples and train.kinv alone; no contract line
        phase_examples(dev, smi)
        x_train, y_train, _, _ = make_data(N_TRAIN, 1, N_FEATURES, SEED)
        phase_train_kinv(x_train, y_train, dev, smi)
        emit("total", seconds=time.perf_counter() - t_start, note="--only-examples")
        return
    # multi-device first, while this process holds nothing on the card: gp_dist_32k's block-cyclic Cholesky and
    # prediction on a 2 x 2 grid of ranks, then sharded fleets
    launches_dist, errs_dist = phase_multi(dev)
    if sys.argv[1:] == ["--only-multi"]:  # a quicker run of the multi-device phases alone; no contract line
        emit("total", seconds=time.perf_counter() - t_start, note="--only-multi")
        return
    if sys.argv[1:] == ["--only-launch"]:  # the launch tools' phases after the multi-device ones; no contract line
        phase_launch(dev)
        emit("total", seconds=time.perf_counter() - t_start, note="--only-launch")
        return
    x_train, y_train, x_test, y_test = make_data(N_TRAIN, N_TEST, N_FEATURES, SEED)
    emit("data", n_train=N_TRAIN, n_test=N_TEST, features=N_FEATURES, tile_size=TILE, seed=SEED,
         config="gp_16k (src/repro/configs/gp_msd.py:11)")
    # the sliding-window path: N_TRAIN + UPDATE_STEPS tiles of consecutive NFIR rows of one series
    x_win, y_win, _, _ = make_data(N_TRAIN + UPDATE_STEPS * TILE, TILE, N_FEATURES, SEED)
    emit("data.update", rows=N_TRAIN + UPDATE_STEPS * TILE, window=N_TRAIN, steps=UPDATE_STEPS,
         step_rows=TILE, seed=SEED, test_points="the main phase's x_test")
    rows = kernel_phases(x_train, x_test, dev)
    rows.update(tile_vector_phase(dev))
    rows["cov_tiles"]["families"] = cov_zoo_phase(x_train, x_test, dev)
    rows["carry_update"] = carry_phase(x_win, y_win, dev)
    phase_grad(dev)
    phase_tf32(x_train, y_train, x_test, dev)
    # warm the libraries and allocator on a small problem before timing
    from repro_torch.core import GaussianProcess

    small = GaussianProcess(x_train[:2048], y_train[:2048], tile_size=TILE, device=dev)
    small.predict_with_uncertainty(x_test[:1024])
    GaussianProcess(x_train[:2048], y_train[:2048], pipeline="monolithic", device=dev).predict(x_test[:1024])
    torch.cuda.synchronize()

    launches = phase_main(x_train, y_train, x_test, y_test, dev)
    launches_update = phase_update(x_win, y_win, x_test, dev)
    phase_timing(x_train, y_train, x_test, dev)
    phase_update_timing(x_win, y_win, x_test, dev)
    phase_profile(x_train, y_train, x_test, x_win, y_win, dev)
    del x_win, y_win

    # training through the kernels, then the kernel zoo on the main path at the trained params
    launches_train, trained = phase_train(x_train, y_train, dev)
    launches_zoo = phase_zoo(x_train, y_train, x_test, dev, trained)
    del trained
    phase_train_profile(x_train, y_train, dev)

    # gp_256k_lowrank: the low-rank tier at gp_256k's sizes, and a window of one series for its steps
    x_lr, y_lr, x_lt, y_lt = make_data(LR_N_TRAIN, LR_N_TEST, N_FEATURES, SEED)
    x_lw, y_lw, _, _ = make_data(LR_N_TRAIN + LR_STEPS * TILE, TILE, N_FEATURES, SEED)
    emit("data.lowrank", n_train=LR_N_TRAIN, n_test=LR_N_TEST, features=N_FEATURES, tile_size=TILE,
         m_inducing=LR_M_INDUCING, strategy="subset", jitter=1e-4, seed=SEED,
         window_rows=LR_N_TRAIN + LR_STEPS * TILE, steps=LR_STEPS, step_rows=TILE,
         config="gp_256k_lowrank: gp_256k's sizes (src/repro/configs/gp_msd.py:19) on the Nystrom tier")
    rows["lrgemm"] = lrgemm_phase(x_lr, y_lr, dev)
    launches_lowrank = phase_lowrank(x_lr, y_lr, x_lt, x_lw, y_lw, dev)
    phase_lowrank_timing(x_lr, y_lr, x_lt, y_lt, x_lw, y_lw, (x_train, y_train, x_test, y_test), dev)
    phase_lowrank_profile(x_lr, y_lr, x_lt, x_lw, y_lw, dev)
    del x_lt, y_lt, x_lw, y_lw
    launches_train_lowrank = phase_train_lowrank(x_lr, y_lr, dev)
    del x_lr, y_lr

    # fleets: GPBatch (per-problem cov_tiles, predictions, training, streaming, the low-rank tier) and GPFleet
    xb, yb, xtb, _ = fleet_data(FLEET_B, FLEET_N, FLEET_NT, SEED)
    emit("data.fleet", batch=dict(problems=FLEET_B, n_train=FLEET_N, n_test=FLEET_NT, seeds=f"{SEED} ... {SEED + FLEET_B - 1}"),
         lowrank=dict(problems=FLEET_LR_B, n_train=FLEET_LR_N, n_test=FLEET_LR_NT, m_inducing=FLEET_LR_M),
         ragged=dict(problems=RAGGED_B, sizes=f"log-uniform in [{RAGGED_LO}, {RAGGED_HI}]", n_test=RAGGED_NT),
         features=N_FEATURES, tile_size=TILE)
    rows["cov_tiles"]["per_problem"] = cov_per_problem_phase(xb, dev)
    launches_fleet, plain = phase_fleet_batch(xb, yb, xtb, dev)
    errs_fleet = [{k: r["max_abs_err"] for k, r in plain.items()}]
    launches_extra = phase_fleet_train(xb, yb, dev)
    launches_fleet = {k: launches_fleet[k] + launches_extra[k] for k in launches_fleet}
    for launches_extra, plain in (phase_fleet_update(*fleet_data(FLEET_B, FLEET_N + TILE, FLEET_NT, SEED)[:2], xtb, dev),
                                  phase_fleet_lowrank(dev)):
        launches_fleet = {k: launches_fleet[k] + launches_extra[k] for k in launches_fleet}
        errs_fleet.append({k: r["max_abs_err"] for k, r in plain.items()})
    launches_ragged, errs_ragged = phase_fleet_ragged(dev)
    launches_ragged_lowrank, errs_ragged_lowrank = phase_fleet_ragged_lowrank(dev)
    # each kernel's largest error at the fleet paths' own widest launches (fleet.*.kernels)
    errs_by_path = {"fleet": {k: max(e[k] for e in errs_fleet if k in e) for k in FLEET_CHECKED
                              if any(k in e for e in errs_fleet)},
                    "fleet_ragged": errs_ragged, "fleet_ragged_lowrank": errs_ragged_lowrank}
    # the serving loop over both fleets, and the cost of telemetry at gp_16k
    phase_serve(x_train, y_train, x_test, dev)
    phase_fleet_timing(xb, yb, xtb, dev)
    del xb, yb, xtb

    errs_by_path["dist"] = errs_dist

    # gemma2-2b served at full width: the flash kernel, then the serving path
    rows["flash_attention"] = flash_phase(dev)
    model, cfg, prompts, launches_lm = phase_lm(dev)
    phase_lm_timing(model, cfg, prompts, dev)
    phase_lm_profile(model, cfg, prompts)
    del model
    torch.cuda.empty_cache()

    # language-model training: gemma2-2b at full width, then lm.mesh's world (olmo-1b on 4 ranks) spawned to run
    # beside the 2-layer cut's gradients and the trainer, which need little of the card
    t_lm = time.perf_counter()
    launches_lm_train, trained = phase_lm_train(dev)
    t_train = time.perf_counter() - t_lm
    profile_lm_train(*trained)  # profile.lm.train: a phase of its own, outside the new phases' budget
    del trained
    torch.cuda.empty_cache()
    t_beside = time.perf_counter()
    world, ckpt = start_lm_mesh()
    phase_lm_train_grad(dev)
    phase_lm_trainer(dev)
    finish_lm_mesh(world, ckpt, beside=["lm.train.grad", "lm.trainer"])
    lm_seconds = t_train + time.perf_counter() - t_beside
    emit("lm.train.total", seconds=lm_seconds, budget_s=LM_NEW_BUDGET_S, lm_train_seconds=t_train,
         beside_seconds=time.perf_counter() - t_beside,
         note="the new language-model phases by the script's clock: lm.train, then lm.mesh's world beside "
         "lm.train.grad and lm.trainer (profile.lm.train, between them, is not counted)")
    check(lm_seconds <= LM_NEW_BUDGET_S, f"the language-model training phases took {lm_seconds} s of {LM_NEW_BUDGET_S}")

    # the recurrent layer kinds at full width: recurrentgemma-2b (rglru and flash on its local layers), mamba2-1.3b
    launches_rec = phase_lm_recurrent(dev)
    # the MoE feed-forward (qwen3-moe, arctic) and the embeddings input (llava, musicgen) at full width
    launches_arch = phase_lm_arch(dev)
    # the launch tools: the dry-run of production cells on fake worlds, its count held against the card
    phase_launch(dev)
    # the examples: the five entry points a user runs, then K^-1 of a training step by both routes at gp_16k
    launches_examples = phase_examples(dev, smi)
    phase_train_kinv(x_train, y_train, dev, smi)

    # launches: each kernel's count on the path it came with (main, update, lowrank, lm)
    path_of = {name: "main" for name in MAIN_KERNELS}
    path_of["carry_update"] = "update"
    path_of["lrgemm"] = "lowrank"
    path_of["flash_attention"] = "lm"
    path_of.update({name: "fleet" for name in VECTOR_KERNELS})
    by_path = {"main": launches, "update": launches_update, "lowrank": launches_lowrank, "lm": launches_lm,
               "lm.train": launches_lm_train, **launches_rec, **launches_arch,
               "zoo": launches_zoo, "train": launches_train, "train_lowrank": launches_train_lowrank,
               "fleet": launches_fleet, "fleet_ragged": launches_ragged,
               "fleet_ragged_lowrank": launches_ragged_lowrank,
               "dist": {k: launches_dist.get(k, 0) for k in NO_LAUNCHES}, "examples": launches_examples}
    kernels = [
        {"name": name, "launches": by_path[path_of[name]][name], **row,
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         "max_abs_err_by_path": {path: errs[name] for path, errs in errs_by_path.items() if name in errs}}
        for name, row in rows.items()
    ]
    check(all(k["launches"] > 0 for k in kernels), f"a kernel never launched on its path: "
          f"{[(k['name'], k['launches']) for k in kernels]}")
    emit("total", seconds=time.perf_counter() - t_start, note="the script's wall time, the kernels' build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
