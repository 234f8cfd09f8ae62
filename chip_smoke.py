#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. env      the card's name and power limit, torch, CUDA and nvcc versions;
2. build    compiles the four kernels from src/repro_torch/kernels/csrc/ with
            nvcc for sm_90a (into build/repro_torch/, git-ignored);
3. kernel   one phase per kernel: its wrapper against its plain PyTorch
            version on the main path's own tiles (gp_16k, m = 512, D = 16,
            float32), plus float64 and ragged-edge cases; times the kernel,
            the plain version and one PyTorch call of the same function;
4. main     the gp_16k configuration (n_train = n_test = 16384, tile 512):
            a cold ``GaussianProcess.predict``, a cold
            ``predict_with_uncertainty`` and a warm ``predict``, with every
            kernel launch counted against the executor's plan, and mean and
            variance held against a float64 dense solve on the card;
5. timing   repeated cold and warm tiled predictions beside the dense
            ``torch.linalg.cholesky`` (cuSOLVER) pipeline;
6. profile  device time by kernel and the device's idle share in one cold
            ``predict`` (``torch.profiler``).

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


def phase_main(x_train, y_train, x_test, y_test, dev):
    """The gp_16k main path, cold and warm, with launch counts checked."""
    from repro_torch.core import GaussianProcess, executor, kernels_math as km
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

    want = [expected(False), expected(True), {"cov_tiles": 1, "potrf": 0, "trsm": 0, "trail": 0}]
    got = [delta(c0, c1), delta(c1, c2), delta(c2, c3)]
    emit("main.launches", calls=["predict (cold, fused)", "predict_with_uncertainty (cold, fused)",
                                 "predict (warm)"], launches=got, plan=want, total=launches)
    check(got == want, f"kernel launches {got} differ from the plan's {want}")
    check(all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}")

    # float64 dense reference on the card (a check only, not a path of the port)
    x64 = torch.from_numpy(x_train).to(dev).double()
    xt64 = torch.from_numpy(x_test).to(dev).double()
    y64 = torch.from_numpy(y_train).to(dev).double()
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
    del v64

    mono = GaussianProcess(x_train, y_train, pipeline="monolithic", device=dev)
    mean_d, t_mono = wall_s(lambda: mono.predict(x_test))
    (mean_du, var_d), t_mono_u = wall_s(lambda: mono.predict_with_uncertainty(x_test))

    def e(a, b):
        return float((a.double() - b).abs().max())

    res = {
        "mean_err_tiled": e(mean, mean_ref),
        "mean_err_tiled_uncertainty_call": e(mean_u, mean_ref),
        "mean_err_warm": e(mean_w, mean_ref),
        "mean_err_dense_f32": e(mean_d, mean_ref),
        "var_err_tiled": e(var_u, var_ref),
        "var_err_dense_f32": e(var_d, var_ref),
        "max_abs_mean_ref": float(mean_ref.abs().max()),
        "max_abs_var_ref": float(var_ref.abs().max()),
        "min_var_tiled": float(var_u.min()),
        "test_rmse_tiled": float(((mean.double() - torch.from_numpy(y_test).to(dev)) ** 2).mean().sqrt()),
    }
    mean_bound = 2 * res["mean_err_dense_f32"] + 1e-4 * res["max_abs_mean_ref"]
    var_bound = 2 * res["var_err_dense_f32"] + 1e-4 * res["max_abs_var_ref"]
    finite = all(bool(torch.isfinite(t).all()) for t in (mean, mean_u, var_u, mean_w))
    shapes = [tuple(t.shape) for t in (mean, mean_u, var_u, mean_w)]
    emit("main.correctness", **res, mean_bound=mean_bound, var_bound=var_bound, finite=finite,
         shapes=shapes, bound_rule="tiled f32 error <= 2 x dense f32 torch.linalg.cholesky "
         "error + 1e-4 max|ref|, both against a float64 dense solve on the card")
    check(finite and shapes == [(N_TEST,)] * 4, f"non-finite or misshapen outputs: {shapes}")
    for name in ("mean_err_tiled", "mean_err_tiled_uncertainty_call", "mean_err_warm"):
        check(res[name] <= mean_bound, f"{name} {res[name]} above {mean_bound}")
    check(res["var_err_tiled"] <= var_bound, f"variance error {res['var_err_tiled']} above {var_bound}")
    emit("main.times", seconds={"tiled_cold_predict": t_cold, "tiled_cold_predict_with_uncertainty": t_cold_u,
                                "tiled_warm_predict": t_warm, "dense_predict": t_mono,
                                "dense_predict_with_uncertainty": t_mono_u},
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def phase_profile(x_train, y_train, x_test, dev):
    """Device time by kernel, and the device's idle share, in one cold predict.

    ``torch.profiler`` traces the card through CUPTI; the run is one stream,
    so the sum of device times is the busy time.  Profiling slows the host,
    so ``wall_ms`` here is above the unprofiled times of phase ``timing``.
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import GaussianProcess

    gp = GaussianProcess(x_train, y_train, tile_size=TILE, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = wall_s(lambda: gp.predict(x_test))
    # device-side events only: a CPU op's self device time repeats its kernels'
    rows = sorted(
        ((e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[2],
    )
    busy_ms = sum(r[2] for r in rows)
    emit("profile", call="predict (cold, fused), gp_16k", wall_ms=wall * 1e3,
         device_busy_ms=busy_ms if rows else "not measured",
         device_idle_share=1.0 - busy_ms / (wall * 1e3) if rows else "not measured",
         top=[{"name": k[:100], "count": c, "device_ms": ms} for k, c, ms in rows[:12]])


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
    rows = kernel_phases(x_train, dev)
    # warm the libraries and allocator on a small problem before timing
    from repro_torch.core import GaussianProcess

    small = GaussianProcess(x_train[:2048], y_train[:2048], tile_size=TILE, device=dev)
    small.predict_with_uncertainty(x_test[:1024])
    GaussianProcess(x_train[:2048], y_train[:2048], pipeline="monolithic", device=dev).predict(x_test[:1024])
    torch.cuda.synchronize()

    launches = phase_main(x_train, y_train, x_test, y_test, dev)
    phase_timing(x_train, y_train, x_test, dev)
    phase_profile(x_train, y_train, x_test, dev)

    kernels = [{"name": name, "launches": launches[name], **row} for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
