#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. env      the card's name and power limit, torch, CUDA and nvcc versions;
2. build    compiles the seven kernels from src/repro_torch/kernels/csrc/ with
            nvcc for sm_90a, in parallel (into build/repro_torch/, git-ignored);
3. kernel   one phase per kernel: its wrapper against its plain PyTorch
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
            carry_update and
            flash_attention must raise under grad; a GaussianProcess must
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
            serializing its wgmma;
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
            prefill that profiles 0 ms of flash fails).

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
NO_LAUNCHES = {k: 0 for k in UPDATE_KERNELS + ("lrgemm", "flash_attention")}
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
    q = torch.randn(1, 128, 2, 64, device=dev, requires_grad=True)
    for name, call in (("carry_update", lambda: ops.carry_update(w, w.detach(), w.detach(), c)),
                       ("flash_attention", lambda: ops.flash_attention(q, q.detach(), q.detach()))):
        try:
            call()
            raised[name] = False
        except RuntimeError as e:
            raised[name] = name in str(e)
    emit("grad.card_vs_cpu",
         nlml={"params": ["lengthscale", "vertical", "noise"], "value_card": v_card, "value_cpu": v_cpu,
               "grad_card": g_card, "grad_cpu": g_cpu, "abs_err": err_i, "max_abs_err": err,
               "tol": GRAD_TOL * scale, "cpu_f32_vs_f64_abs_err": [abs(a - b) for a, b in zip(g_cpu, g_cpu64)],
               "launches": launches_nlml},
         nlml_f64={"value_card": v_card64, "value_cpu": v_cpu64, "grad_card": g_card64, "grad_cpu": g_cpu64,
                   "abs_err": err64_i, "tol": tol64_i},
         logdet={"value_card": ld_card, "value_cpu": ld_cpu, "max_abs_err": err_k, "tol": GRAD_TOL * scale_k,
                 "launches": launches_logdet},
         raise_under_grad=raised, rule="float32: max |card - cpu| <= 1e-4 max |cpu|; float64, each component: "
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
    flash_build_quality()
    return row


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

    b, s = prompts.shape
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
    prefill, decode = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
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

    # decode against the full forward over the same tokens: bf16, then the weights cast to float32
    checked = (0, LM_STEPS - 1)
    full16 = {}
    for bs, r in runs.items():
        seq = torch.cat([prompts[bs], r["fed"]], 1)
        full16[bs] = {i: prefill(model, seq[:, :bs[1] + i + 1])[0] for i in checked}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    model32 = copy.deepcopy(model).float()
    model32.cfg = cfg32
    prefill32, decode32 = serve_step.make_prefill_step(cfg32), serve_step.make_decode_step(cfg32)
    for bs, r in runs.items():
        seq = torch.cat([prompts[bs], r["fed"]], 1)
        r32 = serve(prefill32, decode32, model32, prompts[bs], LM_STEPS, feed=r["fed"])
        check(r32["counts"][0]["flash_attention"] == cfg.n_layers, f"float32 prefill {bs}: {r32['counts'][0]}")
        res = {}
        for i in checked:
            full32 = prefill32(model32, seq[:, :bs[1] + i + 1])[0]
            res[f"token_{bs[1] + i}"] = {
                "gap_f32": max_err(r32["step_logits"][i], full32),
                "gap_bf16": max_err(r["step_logits"][i], full16[bs][i]),
                "decode_bf16_vs_full_f32": max_err(r["step_logits"][i], full32),
                "full_bf16_vs_full_f32": max_err(full16[bs][i], full32),
                "max_abs_logit_f32": float(full32.abs().max()),
            }
        emit("lm.decode_vs_full_forward", batch=list(bs), positions=[bs[1] + i for i in checked], errors=res,
             tol_f32=LM_TOL32, rule=LM_RULE)
        for pos, e in res.items():
            check(e["gap_f32"] <= LM_TOL32, f"{bs} {pos}: float32 decode off the full forward by {e['gap_f32']}")
            bound16 = 2 * e["full_bf16_vs_full_f32"] + LM_TOL32
            check(e["decode_bf16_vs_full_f32"] <= bound16,
                  f"{bs} {pos}: bf16 decode off the float32 full forward by {e['decode_bf16_vs_full_f32']} > {bound16}")
    del model32, full16
    torch.cuda.empty_cache()
    return model, cfg, prompts, total


def phase_lm_timing(model, cfg, prompts, dev):
    """Prefill wall time and tokens/s, decode ms per step, peak memory; a second serve of each batch."""
    from repro_torch.train import serve_step

    prefill, decode = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
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

    prefill, decode = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
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


FLEET_CHECKED = ("cov_tiles", "potrf", "trsm", "trail", "carry_update", "lrgemm")


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
            g = (args[2] if name == "lrgemm" else args[0]).shape[0]
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
                                     trailing_update, trsm_tile)

    def trail_plain(c, a, b, update_dtype=None):
        if update_dtype is not None:
            a, b = a.to(update_dtype), b.to(update_dtype)
        return trailing_update.trail_plain(c, a, b)

    def cov_plain(*args, table=None, **kw):
        return cov_assembly.cov_tiles_plain(*args, **kw)

    plain = {"cov_tiles": cov_plain, "potrf": potrf_tile.potrf_plain, "trsm": trsm_tile.trsm_plain,
             "trail": trail_plain, "carry_update": carry_update.carry_update_plain, "lrgemm": lrgemm_tile.lrgemm_plain}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for name, (g, args, kw) in sorted(kept.items()):
        got = getattr(ops, name)(*args, **kw)
        want = plain[name](*args, **kw)
        err = max_err(got, want)
        scale = max(1.0, float(want.abs().max()))
        m = args[0].shape[1]
        tol = {"cov_tiles": 1e-5, "potrf": 1e-4 * m, "trsm": 1e-3, "trail": 1e-3,
               "carry_update": 1e-3 * scale, "lrgemm": 1e-4 * scale}[name]
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
                 "potrf": by_op["potrf"], "trsm": by_op["trsm"], "trail": by_op[executor.TRAIL]}
    want_warm = {**NO_LAUNCHES, "cov_tiles": 2}
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
    check(c_cold == want, f"fleet.ragged: launches {c_cold} differ from the buckets' plans {want}")
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
    check(c_cold == want and c_warm == want_warm, f"fleet.ragged.lowrank: launches {c_cold} / {c_warm} differ from "
          f"the buckets' plans {want} / {want_warm}")
    check(len(moved) >= 2 and warm, f"fleet.ragged.lowrank update: migrated {moved}, warm {warm}")
    check(c_update == want_update, f"fleet.ragged.lowrank update: launches {c_update}, want chol(B) alone {want_update}")
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
    x_train, y_train, x_test, y_test = make_data(N_TRAIN, N_TEST, N_FEATURES, SEED)
    emit("data", n_train=N_TRAIN, n_test=N_TEST, features=N_FEATURES, tile_size=TILE, seed=SEED,
         config="gp_16k (src/repro/configs/gp_msd.py:11)")
    # the sliding-window path: N_TRAIN + UPDATE_STEPS tiles of consecutive NFIR rows of one series
    x_win, y_win, _, _ = make_data(N_TRAIN + UPDATE_STEPS * TILE, TILE, N_FEATURES, SEED)
    emit("data.update", rows=N_TRAIN + UPDATE_STEPS * TILE, window=N_TRAIN, steps=UPDATE_STEPS,
         step_rows=TILE, seed=SEED, test_points="the main phase's x_test")
    rows = kernel_phases(x_train, x_test, dev)
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

    # gemma2-2b served at full width: the flash kernel, then the serving path
    rows["flash_attention"] = flash_phase(dev)
    model, cfg, prompts, launches_lm = phase_lm(dev)
    phase_lm_timing(model, cfg, prompts, dev)
    phase_lm_profile(model, cfg, prompts)
    del model

    # launches: each kernel's count on the path it came with (main, update, lowrank, lm)
    path_of = {name: "main" for name in MAIN_KERNELS}
    path_of["carry_update"] = "update"
    path_of["lrgemm"] = "lowrank"
    path_of["flash_attention"] = "lm"
    by_path = {"main": launches, "update": launches_update, "lowrank": launches_lowrank, "lm": launches_lm,
               "zoo": launches_zoo, "train": launches_train, "train_lowrank": launches_train_lowrank,
               "fleet": launches_fleet, "fleet_ragged": launches_ragged,
               "fleet_ragged_lowrank": launches_ragged_lowrank}
    kernels = [
        {"name": name, "launches": by_path[path_of[name]][name], **row,
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         "max_abs_err_by_path": {path: errs[name] for path, errs in errs_by_path.items() if name in errs}}
        for name, row in rows.items()
    ]
    emit("total", seconds=time.perf_counter() - t_start, note="the script's wall time, the kernels' build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
