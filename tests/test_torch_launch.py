"""Port parity: the launch tools (``repro_torch.launch``: specs, dry-run, analysis, roofline, production mesh).

Against the JAX package's ``launch`` tools and configs: the shape cells and
``shapes_for``/``all_cells``; ``input_specs`` of every (arch × shape) cell
against the reference's ``ShapeDtypeStruct``s, and each full meta model's
parameter count; the bytes a rank holds of each smoke model on a (4, 2)
mesh against the reference's ``shard_shape`` sums (8 forced host devices in
a subprocess) and the port's (a ``fake`` world of 8 in another); the wire
model against ``parse_collectives`` on the same calls written as HLO lines;
``derive`` with a ``Hardware`` of the v5e's numbers against the reference's.

Meta against real: a 4-rank gloo world on the CPU runs olmo-1b's smoke Adam
step and a small distributed GP prediction on a (2, 2) mesh under
``analysis.measure``; the dry-run's side runs the same cells on meta
tensors as rank 0 of a fake world.  FLOPs, the kernels' operations and
calls, the collectives by op (calls, operand and wire bytes) and the
launches must be equal, not close; the GP's launches equal the schedule's.
The GP probes chained over every step give the factor bitwise and the
variances at 1e-5; the LM probes' sum (each part times its trips) is within
1e-9 of the full step's FLOPs and wire bytes (the parts are the step's own
code, and olmo's pattern of one layer divides its depth).
"""

import math

import numpy as np
import pytest
import torch

from _subproc import run_with_devices
from _torch_dist import World, launch_gp_data, launch_shapes, launch_world, run_in_subprocess
from repro import configs as jconfigs
from repro.core.kernels_math import SEKernelParams as JSE
from repro.launch import hlo_analysis as jha
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.core import distributed as tdist
from repro_torch.launch import analysis, roofline, specs
from repro_torch.launch.mesh import H100_SXM, Hardware

V5E_AS_HARDWARE = Hardware(peak_flops_bf16=197e12, peak_flops_fp32=197e12, hbm_bandwidth=819e9,
                           link_bandwidth=50e9, hbm_bytes=16e9)

_REF_BYTES = r"""
import json, numpy as np, jax
from jax.sharding import NamedSharding
from repro import compat, configs
from repro.dist import sharding as shard_rules
from repro.launch import specs as sp
mesh = compat.make_mesh((4, 2), ("data", "model"))
out = {}
for arch in configs.ARCH_IDS:
    ps = sp.params_shape(configs.get_smoke_config(arch))
    sh = shard_rules.param_shardings(ps, mesh)
    leaves, specs = jax.tree.leaves(ps), jax.tree.leaves(sh, is_leaf=lambda s: isinstance(s, NamedSharding))
    out[arch] = int(sum(np.prod(s.shard_shape(l.shape)) * l.dtype.itemsize for l, s in zip(leaves, specs)))
print("BYTES", json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """The gloo world, the fake world and the reference's 8-device subprocess, run side by side."""
    meta = run_in_subprocess("launch_meta", timeout=240)
    world = World(launch_world, 4, timeout=240)
    ref = run_with_devices(_REF_BYTES, n_devices=8, timeout=240)
    ref_bytes = __import__("json").loads(ref.split("BYTES", 1)[1])
    return {"meta": meta.result(), "real": world.join(), "ref_bytes": ref_bytes}


# ---------------------------------------------------------------------------
# 1-2: the shape cells and the stand-ins
# ---------------------------------------------------------------------------


def test_shape_cells_are_the_references():
    assert configs.ALL_SHAPES == tuple(configs.ShapeConfig(**vars(s)) for s in jconfigs.ALL_SHAPES)
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    for arch in configs.ARCH_IDS:
        assert [vars(s) for s in configs.shapes_for(arch)] == [vars(s) for s in jconfigs.shapes_for(arch)]
    assert [(a, vars(s)) for a, s in configs.all_cells()] == [(a, vars(s)) for a, s in jconfigs.all_cells()]
    assert len(list(configs.all_cells())) == 32


def _ref_cache_leaves(ref_caches, cfg):
    """The reference's stacked caches as one {name: (shape, dtype)} a layer, in the port's layer order."""
    p = len(cfg.pattern)
    cycles = cfg.n_layers // p
    out = []
    for layer in range(cfg.n_layers):
        if layer < cycles * p:
            group = ref_caches["groups"][layer % p]
            out.append({k: (tuple(v.shape[1:]), v.dtype) for k, v in group.items()})
        else:
            out.append({k: (tuple(v.shape), v.dtype) for k, v in ref_caches["tail"][layer - cycles * p].items()})
    return out


def _dt(x):
    return str(x).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", [pytest.param(a, s, id=f"{a}-{s.name}") for a, s in configs.all_cells()])
def test_input_specs_match_the_references(arch, shape):
    cfg = configs.get_config(arch)
    got = specs.input_specs(cfg, shape)
    want = jspecs.input_specs(jconfigs.get_config(arch), shape)
    assert set(got) == set(want)
    for name in got:
        if name == "caches":
            ref = _ref_cache_leaves(want["caches"], cfg)
            mine = [{k: (tuple(v.shape), _dt(v.dtype)) for k, v in c.items()} for c in got["caches"]]
            assert mine == [{k: (s, str(d)) for k, (s, d) in c.items()} for c in ref]
            assert all(v.device.type == "meta" for c in got["caches"] for v in c.values())
            continue
        assert got[name].device.type == "meta"
        assert (tuple(got[name].shape), _dt(got[name].dtype)) == (tuple(want[name].shape), str(want[name].dtype))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_full_meta_model_counts_its_parameters(arch):
    """Every weight of the full model, as ``param_count`` counts (its norms, convolutions and scalars aside), with
    the rglru feed-forward ``param_count`` leaves out (ROADMAP §3 item 4) added."""
    uncounted = ("norm", "rec.conv_b", "ssm.conv_w", "ssm.conv_b", "ssm.a_log", "ssm.d_skip", "ssm.dt_bias")
    cfg = configs.get_config(arch)
    model = specs.params_shape(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    count = sum(p.numel() for n, p in model.named_parameters() if not any(u in n for u in uncounted))
    rglru_ffn = sum(cfg._ffn_params(cfg.d_ff) for kind in cfg.layer_kinds() if kind == "rglru")
    assert count == cfg.param_count() + rglru_ffn


# ---------------------------------------------------------------------------
# 3: the bytes a rank holds
# ---------------------------------------------------------------------------


def test_bytes_a_rank_holds_match_the_references(runs):
    assert runs["meta"]["world"] == 8
    assert runs["meta"]["bytes"] == runs["ref_bytes"]


# ---------------------------------------------------------------------------
# 4-5: the wire model and the roofline
# ---------------------------------------------------------------------------


def _hlo_line(op, group, nbytes, total):
    return (f"%{op} = f32[{nbytes // 4}]{{0}} {op}(%x), channel_id=1, "
            f"replica_groups=[{total // group},{group}]<=[{total}], use_global_device_ids=true\n")


@pytest.mark.parametrize("total", [8, 512])
def test_wire_model_matches_parse_collectives(total):
    rng = np.random.default_rng(total)
    calls = [(str(rng.choice(["all-reduce", "all-gather"])), int(rng.choice([1, 2, 4, 8])), 4 * int(rng.integers(1, 4096)))
             for _ in range(40)]
    got = analysis.collective_stats(calls)
    want = jha.parse_collectives("".join(_hlo_line(op, g, b, total) for op, g, b in calls), total)
    assert got.ops == want.ops
    for k in want.ops:
        assert got.operand_bytes[k] == pytest.approx(want.operand_bytes[k], rel=1e-12)
        assert got.wire_bytes[k] == pytest.approx(want.wire_bytes[k], rel=1e-12)
    assert got.total_wire_bytes == pytest.approx(want.total_wire_bytes, rel=1e-12)


def test_collective_stats_merged_scaling():
    a = analysis.CollectiveStats({"all-reduce": 1}, {"all-reduce": 10.0}, {"all-reduce": 20.0})
    b = analysis.CollectiveStats({"all-reduce": 2}, {"all-reduce": 5.0}, {"all-reduce": 7.0})
    m = a.merged(b, scale=3.0)
    assert m.ops["all-reduce"] == 7
    assert m.wire_bytes["all-reduce"] == 20.0 + 21.0
    assert m.operand_bytes["all-reduce"] == 10.0 + 15.0
    c = a.merged(analysis.CollectiveStats({"all-gather": 1}, {"all-gather": 2.0}, {"all-gather": 3.0}))
    assert c.ops == {"all-reduce": 1, "all-gather": 1} and c.total_wire_bytes == 23.0


def _records():
    full = {"memory": {"peak_bytes": 12.5e9}, "cost": {"flops": 3.0e15, "bytes": 4.0e12},
            "collectives": {"total_wire_bytes": 7.0e10}}
    base = {"kind": "lm", "arch": "gemma2-2b", "shape": {"name": "train_4k"}, "mesh": "pod16x16", "devices": 256,
            "model_flops": 6.0e17, "ok": True, "full": full, "fits_16gb": True}
    corrected = dict(base, corrected={"flops": 5.0e15, "bytes": 2.0e12, "wire_bytes": 9.0e11})
    big = dict(base, full=dict(full, memory={"peak_bytes": 30e9}), fits_16gb=False)
    failed = {"kind": "lm", "arch": "arctic-480b", "shape": {"name": "decode_32k"}, "mesh": "pod2x16x16",
              "devices": 512, "ok": False, "error": "ValueError: x"}
    return [base, corrected, big, failed]


@pytest.mark.parametrize("i", range(3))
def test_derive_matches_the_references_on_a_v5e(i):
    rec = _records()[i]
    want = jroof.derive(rec)
    got = roofline.derive(rec, V5E_AS_HARDWARE)
    for key, value in want.items():
        if key == "fits_16gb":
            assert got["fits"] == value
        else:
            assert got[key] == value, key
    assert roofline.markdown_table([got]).splitlines()[2].split("|")[:7] == \
        jroof.markdown_table([want]).splitlines()[2].split("|")[:7]


def test_derive_of_a_failed_record():
    """The reference's ``derive`` reads ``rec["full"]`` of a record without ``corrected`` and so raises on the
    failed cells its dry-run records; the port's gives the row its table prints as FAILED."""
    rec = _records()[3]
    with pytest.raises(KeyError):
        jroof.derive(rec)
    row = roofline.derive(rec, V5E_AS_HARDWARE)
    assert not row["ok"] and row["error"] == "ValueError: x" and row["peak_gb"] is None
    assert "FAILED: ValueError: x" in roofline.markdown_table([row])
    assert "FAILED: ValueError: x" in roofline.paired_table([row])


def test_derive_on_the_h100_takes_the_cells_compute_type():
    rec = dict(_records()[0], compute_dtype="float32")
    assert roofline.derive(rec)["compute_s"] == pytest.approx(3.0e15 / 67e12)
    assert roofline.derive(_records()[0])["compute_s"] == pytest.approx(3.0e15 / 989e12)
    assert roofline.derive(_records()[0])["collective_s"] == pytest.approx(7.0e10 / 50e9)
    assert H100_SXM.hbm_bytes == 80e9 and roofline.derive(_records()[2])["fits"]
    port = roofline.derive(dict(_records()[0], corrected="full"))  # the port's records: the full run's totals
    assert port["basis"] == "full (every layer)" and port["compute_s"] == pytest.approx(3.0e15 / 989e12)


# ---------------------------------------------------------------------------
# 6-7: meta against real, and the probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lm", "gp"])
def test_meta_run_counts_equal_the_real_run(runs, cell):
    real, meta = runs["real"][0][cell], runs["meta"][cell]
    assert real["flops"] == meta["flops"] and real["kernel_flops"] == meta["kernel_flops"]
    assert real["collectives"] == meta["collectives"]
    assert real["kernel_calls"] == meta["kernel_calls"]
    assert real["launches"] == meta["launches"] == meta["kernel_calls"]
    assert real["launched"] == meta["launched"] == {}  # only the card launches a kernel
    assert meta["flops"] + meta["kernel_flops"] > 0 and meta["collectives"][0]
    if cell == "gp":
        _, gp_shape = launch_shapes()
        m_tiles = gp_shape.n_train // gp_shape.tile_size
        assert meta["launches"] == tdist.schedule_launches(m_tiles, 2, 2, 0, 0, predict=True)


def test_gp_probes_chain_to_the_factor_and_the_variances(runs):
    for rank in runs["real"]:
        assert rank["chol_probe_bitwise"]
        assert rank["var_probe_err"] <= 1e-5
    x, _, _ = launch_gp_data()
    p, q = runs["real"][0]["grid"]
    from repro_torch.core import tiling

    d2 = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    se = JSE.paper_defaults()
    lengthscale, vertical, noise = se.lengthscale, se.vertical, se.noise
    k = vertical * np.exp(-0.5 / lengthscale * d2) + noise * np.eye(len(x))
    want = np.linalg.cholesky(k)
    cyc = torch.from_numpy(runs["real"][0]["factor"])
    got = np.tril(tiling.untile_dense(tdist.from_cyclic_layout(cyc, p, q)).numpy())
    np.testing.assert_allclose(got, want, atol=1e-3)  # the distributed tests' tolerance


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lm_probes_sum_to_the_full_step(runs, kind):
    probes = runs["meta"]["probes"][kind]
    flops, wire = probes["full"]
    parts = probes["parts"]
    assert set(parts) == ({"cycle", "head", "optimizer"} if kind == "train" else {"cycle", "head"})
    assert parts["cycle"][2] == configs.get_smoke_config("olmo-1b").n_layers
    assert sum(f * t for f, _, t in parts.values()) == pytest.approx(flops, rel=1e-9)
    assert sum(w * t for _, w, t in parts.values()) == pytest.approx(wire, rel=1e-9)
    assert math.isfinite(flops) and flops > 0


# ---------------------------------------------------------------------------
# The kernels' meta route and the counting scope
# ---------------------------------------------------------------------------


def _op_args(name, device):
    """Seeded operands of one ``ops`` entry on ``device``; (fn, args, kwargs)."""
    from repro_torch.core.kernels_math import SEKernelParams
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, dtype=dtype).to(device)

    m = 8
    spd = torch.randn(3, m, m, generator=g)
    spd = spd @ spd.mT + m * torch.eye(m)
    spd, lower = spd.to(device), torch.linalg.cholesky(spd).to(device)
    if name == "potrf":
        return ops.potrf, (spd,), {}
    if name == "trsm":
        return ops.trsm, (lower, r(3, m, m)), {}
    if name == "trail":
        return ops.trail, (r(3, m, m), r(3, m, m), r(3, m, m)), {}
    if name == "carry_update":
        return ops.carry_update, (r(3, m, m), r(3, m, m), r(3, m, m), lower), {}
    if name == "cov_tiles":
        return ops.cov_tiles, (r(4, m, 3), r(4, 5, 3), 0, 0, 20, 20, SEKernelParams()), {"symmetric": False}
    if name == "lrgemm":
        idx = torch.tensor([0, 2, 1]).to(device)
        return ops.lrgemm, (r(3, m, 5), r(4, 5), idx, idx), {}
    if name == "tile_gemv":
        return ops.tile_gemv, (r(2, 3, 2, m, 5), r(2, 3, 2, 5)), {}
    if name == "tile_trsv":
        return ops.tile_trsv, (lower.expand(2, 3, m, m).contiguous(), r(2, 3, m)), {"transpose": True}
    return ops.flash_attention, (r(2, 12, 4, m, dtype=torch.bfloat16), r(2, 12, 2, m, dtype=torch.bfloat16),
                                 r(2, 12, 2, m, dtype=torch.bfloat16)), {"window": 5, "softcap": 30.0}


KERNEL_OPS = ("potrf", "trsm", "trail", "carry_update", "cov_tiles", "lrgemm", "tile_gemv", "tile_trsv",
              "flash_attention")


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_meta_route_gives_the_kernels_shape_and_counts_alike(name, monkeypatch):
    """On meta tensors an op returns its kernel's output shape and type, runs no plain version and launches
    nothing; under ``ops.counting`` every route adds the same launches, operations and bytes, and a
    FlopCounterMode around it sees none of the plain version's ops."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops

    fn, args, kw = _op_args(name, "cpu")
    with FlopCounterMode(display=False) as flops, ops.counting() as cpu_count:
        want = fn(*args, **kw)
    assert flops.get_total_flops() == 0
    fn, meta_args, kw = _op_args(name, "meta")
    for mod, plain in ((ops._potrf, "potrf_plain"), (ops._trsm, "trsm_plain"), (ops._trail, "trail_plain"),
                       (ops._carry, "carry_update_plain"), (ops._cov, "cov_tiles_plain"),
                       (ops._lrgemm, "lrgemm_plain"), (ops._gemv, "tile_gemv_plain"), (ops._gemv, "tile_trsv_plain"),
                       (ops._flash, "flash_attention_plain")):
        monkeypatch.setattr(mod, plain, lambda *a, **k: pytest.fail("the meta route ran a plain version"))
    ops.reset_launch_counts()
    with ops.counting() as meta_count:
        got = fn(*meta_args, **kw)
    assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
    assert ops.launch_counts() == {k: 0 for k in ops.KERNEL_OPS}
    assert meta_count.calls == cpu_count.calls == meta_count.launches == cpu_count.launches == {name: 1}
    assert meta_count.ops == cpu_count.ops and meta_count.bytes == cpu_count.bytes
    assert meta_count.total_ops > 0 and meta_count.total_bytes > 0
    ops.reset_launch_counts()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 3, 7, 40])
def test_attention_pairs_counts_the_kept_mask_entries(causal, window):
    """The flash kernel's closed-form pair count against the mask it keeps, entry by entry."""
    from repro_torch.kernels import ops

    for s in range(0, 24, 5):
        for t in range(0, 24, 3):
            i, j = np.arange(s)[:, None], np.arange(t)[None, :]
            keep = np.ones((s, t), bool)
            if causal:
                keep &= j <= i
            if window is not None:
                keep &= j > i - window
            assert ops.attention_pairs(s, t, causal, window) == int(keep.sum()), (s, t)


def test_no_route_for_another_device():
    from types import SimpleNamespace

    from repro_torch.kernels import ops

    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops._on_cuda(SimpleNamespace(device=torch.device("xpu")), "potrf")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops._on_cuda(torch.empty(2, device="meta"), "potrf")  # meta goes to its own route before _on_cuda
