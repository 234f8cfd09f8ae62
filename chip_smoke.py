#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. env      the card's name and power limit, torch, CUDA and nvcc versions;
2. build    compiles the six kernels from src/repro_torch/kernels/csrc/ with
            nvcc for sm_90a, in parallel (into build/repro_torch/, git-ignored);
3. kernel   one phase per kernel: its wrapper against its plain PyTorch
            version on its path's own tiles (gp_16k, m = 512, D = 16,
            float32), plus float64 and ragged-edge cases; times the kernel,
            the plain version and one PyTorch call of the same function;
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
8. kernel.lrgemm  the low-rank tier's kernel at the gp_256k build's shape
            (G = 2048 tiles of 512 x 512, float32) against its plain version,
            plus float64, odd G and mb != m; times it beside ``torch.bmm``;
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
            and of one step.

Every phase prints one JSON line.  The kernels' summary, the nvidia-smi line
and, last, ``{"ok": true, "device": {...}}`` follow.  Any failed check exits
non-zero before the last line; so does a machine without CUDA, or a directory
that holds this script without the package.
"""

from __future__ import annotations

import json
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
NO_LAUNCHES = {k: 0 for k in UPDATE_KERNELS + ("lrgemm",)}
# the sliding-window path: a window of N_TRAIN rows, UPDATE_STEPS steps of one tile
UPDATE_STEPS = 2
# gp_256k_lowrank: gp_256k's sizes (src/repro/configs/gp_msd.py:19) on the
# Nystrom tier, m_inducing = 2048 (4 tiles), subset inducing points, jitter 1e-4
LR_N_TRAIN = 262144
LR_N_TEST = 16384
LR_M_INDUCING = 2048
LR_STEPS = 2

# Published peaks of one H100 SXM (dense, at the 700 W limit): FP32 on the
# CUDA cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
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


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
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


def kernel_phases(x_train: np.ndarray, dev: torch.device):
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

    def cov_k():
        return ops.cov_tiles(xa, xb, r0, c0, n, n, params, symmetric=True)

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


def dense_reference(x_train, y_train, x_test, dev):
    """(mean, variance) of a float64 dense solve on the card (a check, not a path of the port)."""
    from repro_torch.core import kernels_math as km

    x64 = torch.as_tensor(x_train, device=dev).double()
    xt64 = torch.as_tensor(x_test, device=dev).double()
    y64 = torch.as_tensor(y_train, device=dev).double()
    p = km.SEKernelParams.paper_defaults()
    k64 = km.assemble_covariance(x64, p)
    l64 = torch.linalg.cholesky(k64)
    del k64
    alpha64 = torch.cholesky_solve(y64[:, None], l64)[:, 0]
    ks64 = km.assemble_cross_covariance(xt64, x64, p)
    mean_ref = ks64 @ alpha64
    v64 = torch.linalg.solve_triangular(l64, ks64.mT, upper=False)
    del ks64, l64
    var_ref = p.vertical - (v64 * v64).sum(0)
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
            "cov_tiles": sum(by_op.get(o, 0) for o in ("assemble", "cross", "prior")),
            "potrf": by_op.get("potrf", 0),
            "trsm": by_op.get("trsm", 0),
            "trail": by_op.get(executor.TRAIL, 0),
            "carry_update": 0,
            "lrgemm": 0,
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
         f64_ms=cuda_ms(lambda: ops.carry_update(*d64), 5),
         **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    check(err <= tol, f"carry_update disagrees with its plain version: {err} > {tol}")
    check(err64 <= tol64, f"carry_update (float64) disagrees with its plain version: {err64} > {tol64}")
    torch.cuda.synchronize()
    return row


def update_launches_per_step():
    """Kernel launches of one step at gp_16k: append one tile-row to M tiles, evict one tile."""
    from repro_torch.core import executor

    m_tiles = N_TRAIN // TILE
    ap = executor.update_append_plan(m_tiles, m_tiles).launches_by_op()
    rp = executor.update_rank_plan(m_tiles).launches_by_op()
    return {
        "cov_tiles": ap["uasm"] + ap["uasmd"],
        "potrf": ap["upotrf"] + 2 * rp["uprep"],  # UPREP factors two tiles
        "trsm": ap["utrsm"],
        "trail": ap["ugemm"] + ap["usyrk"],
        "carry_update": rp["ucarry"],
        "lrgemm": 0,
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


def profile_call(phase: str, call: str, fn) -> None:
    """Device time by kernel, and the device's idle share, over one call of ``fn``.

    ``torch.profiler`` traces the card through CUPTI; the run is one stream,
    so the sum of device times is the busy time.  Profiling slows the host,
    so ``wall_ms`` here is above the unprofiled times of phase ``timing``.
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
    emit(phase, call=call, wall_ms=wall * 1e3,
         device_busy_ms=busy_ms if rows else "not measured",
         device_idle_share=1.0 - busy_ms / (wall * 1e3) if rows else "not measured",
         top=[{"name": k[:100], "count": c, "device_ms": ms} for k, c, ms in rows[:14]])


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
    kuu = km.assemble_covariance(u, p)
    kuu.diagonal().add_(torch.tensor(DEFAULT_JITTER, dtype=dtype, device=dev) - p.noise)
    luu = torch.linalg.cholesky(kuu)
    kun = km.assemble_cross_covariance(u, x, p)
    c = kun @ y[:, None]
    w = solve(luu, kun)
    del kun
    lb = torch.linalg.cholesky(torch.eye(u.shape[0], dtype=dtype, device=dev) + (w @ w.mT) / p.noise)
    wy = w @ y[:, None]
    del w
    kus = km.assemble_cross_covariance(u, xt, p)
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


def lowrank_launches():
    """Kernel launches of the low-rank path's pieces, from the plans (MU = 4 inducing tiles)."""
    from repro_torch.core import executor

    mu_tiles = LR_M_INDUCING // TILE
    chol = executor.cholesky_plan(mu_tiles).launches_by_op()
    one_chol = {"potrf": chol["potrf"], "trsm": chol["trsm"], "trail": chol["syrk"] + chol["gemm"]}

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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the root of a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = phase_env()
    phase_build()
    x_train, y_train, x_test, y_test = make_data(N_TRAIN, N_TEST, N_FEATURES, SEED)
    emit("data", n_train=N_TRAIN, n_test=N_TEST, features=N_FEATURES, tile_size=TILE, seed=SEED,
         config="gp_16k (src/repro/configs/gp_msd.py:11)")
    # the sliding-window path: N_TRAIN + UPDATE_STEPS tiles of consecutive NFIR rows of one series
    x_win, y_win, _, _ = make_data(N_TRAIN + UPDATE_STEPS * TILE, TILE, N_FEATURES, SEED)
    emit("data.update", rows=N_TRAIN + UPDATE_STEPS * TILE, window=N_TRAIN, steps=UPDATE_STEPS,
         step_rows=TILE, seed=SEED, test_points="the main phase's x_test")
    rows = kernel_phases(x_train, dev)
    rows["carry_update"] = carry_phase(x_win, y_win, dev)
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

    # launches: each kernel's count on the path it came with (main, update, lowrank)
    path_of = {name: "main" for name in MAIN_KERNELS}
    path_of["carry_update"] = "update"
    path_of["lrgemm"] = "lowrank"
    by_path = {"main": launches, "update": launches_update, "lowrank": launches_lowrank}
    kernels = [
        {"name": name, "launches": by_path[path_of[name]][name], **row,
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()}}
        for name, row in rows.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
