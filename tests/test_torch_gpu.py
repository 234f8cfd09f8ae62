"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the ``repro`` package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.core import GaussianProcess, GPBatch, GPFleet, executor, lowrank, mll, tiling, triangular
from repro_torch.core import kernels_math as km
from repro_torch.kernels import (
    _build, carry_update, cov_assembly, flash_attention, lrgemm_tile, ops, potrf_tile, trailing_update, trsm_tile,
)
from repro_torch.models import transformer as tf

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# TRAIL's instantiations: G in {1, 3, 40} takes both tile sizes and m in
# {77, 129} the scalar loads (tests/test_torch_kernels.py checks the grid
# reaches every (tile, load width) of trailing_update.trail_variant)
TRAIL_GRID = [(g, m) for g in (1, 3, 40) for m in (16, 77, 100, 128, 129, 512)]


@pytest.mark.parametrize(
    "dtype,g,m,tol",
    [(torch.float32, 3, 100, 1e-3), (torch.float64, 3, 64, 1e-10)]
    + [(torch.float32, g, m, 1e-3) for g, m in TRAIL_GRID if (g, m) != (3, 100)]
    + [(torch.float64, g, m, 1e-10) for g, m in TRAIL_GRID],
)
def test_kernels_match_plain(cuda, dtype, g, m, tol):
    gen = torch.Generator().manual_seed(0)
    r = torch.randn(g, m, m, generator=gen, dtype=dtype)
    spd = (r @ r.mT / m + torch.eye(m, dtype=dtype)).to(cuda)
    rhs = torch.randn(g, m, m, generator=gen, dtype=dtype).to(cuda)
    lo = potrf_tile.potrf_plain(spd)
    ops.reset_launch_counts()
    assert (ops.potrf(spd) - lo).abs().max() <= tol * m
    assert (ops.trsm(lo, rhs) - trsm_tile.trsm_plain(lo, rhs)).abs().max() <= tol * m
    assert (ops.trail(spd, lo, rhs) - trailing_update.trail_plain(spd, lo, rhs)).abs().max() <= tol * m
    x = torch.randn(g, m, 3, generator=gen, dtype=dtype).to(cuda)
    p = km.SEKernelParams(1.3, 0.8, 0.05)
    for sym in (True, False):
        got = ops.cov_tiles(x, x, 0, 0, m - 5, m - 9, p, symmetric=sym)
        want = cov_assembly.cov_tiles_plain(x, x, 0, 0, m - 5, m - 9, p, symmetric=sym)
        assert (got - want).abs().max() <= tol
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "cov_tiles": 2, "potrf": 1, "trsm": 1, "trail": 1, "carry_update": 0, "lrgemm": 0,
        "flash_attention": 0, "tile_gemv": 0, "tile_trsv": 0,
    }


@pytest.mark.parametrize(
    "dtype,g,m,tol",
    [(torch.float32, 3, 512, 1e-3), (torch.float32, 4, 100, 1e-3), (torch.float64, 3, 77, 1e-10),
     (torch.float64, 2, 512, 1e-10), (torch.float32, 3, 77, 1e-3), (torch.float32, 2, 256, 1e-3),
     (torch.float64, 4, 100, 1e-10), (torch.float64, 2, 256, 1e-10),
     (torch.float32, 2, 2048, 1e-3), (torch.float64, 2, 2048, 1e-10)],
)
def test_carry_update_matches_plain(cuda, dtype, g, m, tol):
    """(W - L Y) C^{-T}: the kernel against its plain version, C = chol(I + R R^T / m).

    m = 77 and 100 take the scalar loads in float64 (77 also in float32);
    m = 2048 takes a shorter strip than m <= 1472 (float32) and 1440 (float64).
    """
    gen = torch.Generator().manual_seed(3)
    w, l, y, r = (torch.randn(g, m, m, generator=gen, dtype=dtype) / m**0.5 for _ in range(4))
    c = potrf_tile.potrf_plain(torch.eye(m, dtype=dtype) + r @ r.mT)
    w, l, y, c = (t.to(cuda) for t in (w, l, y, c))
    ops.reset_launch_counts()
    got = ops.carry_update(w, l, y, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["carry_update"] == 1
    assert got.dtype == dtype and got.shape == (g, m, m)
    assert (got - carry_update.carry_update_plain(w, l, y, c)).abs().max() <= tol


@pytest.mark.parametrize(
    "dtype,g,m,mb,tol,repeated",
    [(torch.float32, 64, 512, 512, 1e-4, False), (torch.float32, 7, 100, 60, 1e-4, False),
     (torch.float32, 5, 77, 45, 1e-4, False), (torch.float64, 7, 100, 60, 1e-12, False),
     (torch.float64, 3, 512, 384, 1e-12, False), (torch.float64, 5, 33, 45, 1e-12, False),
     (torch.float32, 1, 512, 512, 1e-4, False), (torch.float32, 133, 512, 512, 1e-4, True),
     (torch.float64, 133, 512, 512, 1e-12, True), (torch.float32, 300, 64, 2048, 1e-4, True),
     (torch.float32, 9, 100, 45, 1e-4, True), (torch.float64, 270, 128, 256, 1e-12, False)],
)
def test_lrgemm_matches_plain(cuda, dtype, g, m, mb, tol, repeated):
    """kflat[a[g]] @ v[b[g]]: odd G, mb != m, odd mb (the scalar path), both types.

    G = 1 lies below one wave of the persistent grid (one CTA per SM), G =
    133 is not a multiple of it; ``repeated`` draws a[g] with repeats.
    """
    gen = torch.Generator().manual_seed(4)
    kflat = torch.randn(g + 3, m, mb, generator=gen, dtype=dtype).to(cuda)
    v = torch.randn(4, mb, generator=gen, dtype=dtype).to(cuda)
    if repeated:
        a = torch.randint(0, g + 3, (g,), generator=gen).to(cuda)
    else:
        a = torch.randperm(g + 3, generator=gen)[:g].to(cuda)
    b = torch.randint(0, 4, (g,), generator=gen).to(cuda)
    ops.reset_launch_counts()
    got = ops.lrgemm(kflat, v, a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lrgemm"] == 1
    assert got.dtype == dtype and got.shape == (g, m)
    want = lrgemm_tile.lrgemm_plain(kflat, v, a, b)
    assert (got - want).abs().max() <= tol * max(1.0, float(want.abs().max()))
    # an index out of range gives NaN rows, never an out-of-bounds read
    bad = lrgemm_tile.lrgemm_cuda(kflat, v, a, torch.full_like(b, 4))
    torch.cuda.synchronize()
    assert bool(torch.isnan(bad).all())
    a_bad, b_bad = a.clone(), b.clone()
    a_bad[::3], b_bad[1::3] = -1, 4
    some = lrgemm_tile.lrgemm_cuda(kflat, v, a_bad, b_bad)
    torch.cuda.synchronize()
    out_of_range = (a_bad < 0) | (b_bad >= 4)
    assert bool(torch.isnan(some[out_of_range]).all())
    assert torch.equal(some[~out_of_range], got[~out_of_range])


def test_gp_lowrank_on_the_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(300, 4, generator=gen)
    y = torch.sin(x.sum(-1))
    xt = torch.randn(77, 4, generator=gen)
    kw = dict(tile_size=64, method="lowrank", m_inducing=96)
    ops.reset_launch_counts()
    gp = GaussianProcess(x, y, device=cuda, **kw)
    mean, var = gp.predict_with_uncertainty(xt)
    gp.update(x[:50], y[:50])
    gp.forget(50)
    warm = gp.predict(xt)
    counts = ops.launch_counts()
    ref_mean, ref_var = GaussianProcess(x, y, device="cpu", **kw).predict_with_uncertainty(xt)
    assert (mean.cpu() - ref_mean).abs().max() <= 1e-3
    assert (var.cpu() - ref_var).abs().max() <= 1e-3
    assert (warm.cpu() - ref_mean).abs().max() <= 2e-3
    # lrgemm: c = K_un y and c_w = W y in the build and in each absorb
    assert counts["lrgemm"] == 2 + 2 + 2 and counts["cov_tiles"] == 2 + 2 + 2 + 1


@pytest.mark.parametrize("g,m", [(5, 96)] + TRAIL_GRID)
def test_trail_bf16_operands(cuda, g, m):
    """bf16 A and B with float32 C; m = 77, 100 and 129 take the scalar loads (rows of 8 bf16)."""
    gen = torch.Generator().manual_seed(1)
    c, a, b = (torch.randn(g, m, m, generator=gen).to(cuda) for _ in range(3))
    bf = torch.bfloat16
    got = ops.trail(c, a, b, bf)
    want = trailing_update.trail_plain(c, a.to(bf), b.to(bf))
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-3


def test_carry_two_ctas_per_sm(cuda):
    """Two CTAs of the float32 carry kernel fit on an SM at gp_16k's tile (m = 512), on the 32-row strip."""
    lib = _build.load("carry_update")
    assert lib.carry_update_f32_ctas_per_sm(512) >= 2
    assert lib.carry_update_f32_strip(512) == 32
    assert [lib.carry_update_f32_strip(m) for m in (1472, 1473, 3232, 3233)] == [32, 16, 16, 8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_carry_update_past_the_limit_raises(cuda, dtype):
    """A tile past the shortest strip's limit is refused with ValueError, before any launch."""
    limit = _build.load("carry_update").carry_update_max_m(int(dtype == torch.float64))
    assert limit >= (3500 if dtype == torch.float32 else 1700)
    w = torch.zeros(1, limit + 1, limit + 1, dtype=dtype, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=f"up to m = {limit}"):
        ops.carry_update(w, w, w, w)
    assert ops.launch_counts()["carry_update"] == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
@pytest.mark.parametrize("m", [16, 100, 512, 1024])
@pytest.mark.parametrize("g", [1, 2, 31])
def test_trsm_matches_plain(cuda, g, m, dtype, tol):
    """X L^T = B against the column recurrence, L = chol(I + R R^T / m): every strip height the launcher picks.

    float32 within 1e-3, float64 within 1e-10 m; G = 1 runs the shortest strip on the most CTAs,
    G = 31 at m >= 512 the tallest; m = 100 takes the scalar copies in neither type (16-byte rows).
    """
    gen = torch.Generator().manual_seed(11)
    r = torch.randn(g, m, m, generator=gen, dtype=dtype)
    l = potrf_tile.potrf_plain(torch.eye(m, dtype=dtype) + r @ r.mT / m).to(cuda)
    b = torch.randn(g, m, m, generator=gen, dtype=dtype).to(cuda)
    ops.reset_launch_counts()
    got = ops.trsm(l, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["trsm"] == 1
    assert got.dtype == dtype and got.shape == (g, m, m)
    bound = tol if dtype == torch.float32 else tol * m
    assert (got - trsm_tile.trsm_plain(l, b)).abs().max() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trsm_strips_and_ragged_tiles(cuda, dtype):
    """m = 77 takes the scalar copies; the strip follows G and m (the card's SM count) and keeps the limit."""
    lib = _build.load("trsm_tile")
    f64 = int(dtype == torch.float64)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert lib.trsm_strip(1, 512, f64, sms) == 8 and lib.trsm_strip(31, 512, f64, sms) == (16 if f64 else 32)
    assert lib.trsm_max_m(f64) == _build.load("carry_update").carry_update_max_m(f64)
    gen = torch.Generator().manual_seed(12)
    for g, m in ((3, 77), (40, 77), (1, 33)):
        r = torch.randn(g, m, m, generator=gen, dtype=dtype)
        l = potrf_tile.potrf_plain(torch.eye(m, dtype=dtype) + r @ r.mT / m).to(cuda)
        b = torch.randn(g, m, m, generator=gen, dtype=dtype).to(cuda)
        assert (ops.trsm(l, b) - trsm_tile.trsm_plain(l, b)).abs().max() <= (1e-3 if not f64 else 1e-10 * m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trsm_past_the_limit_raises(cuda, dtype):
    """A tile past the strip solve's limit is refused with ValueError, before any launch."""
    limit = _build.load("trsm_tile").trsm_max_m(int(dtype == torch.float64))
    assert limit == (6816 if dtype == torch.float32 else 3168)
    t = torch.zeros(1, limit + 1, limit + 1, dtype=dtype, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=f"up to m = {limit}"):
        ops.trsm(t, t)
    assert ops.launch_counts()["trsm"] == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("d", [1, 3, 16, 40])
@pytest.mark.parametrize("symmetric", [True, False])
def test_cov_tiles_matches_plain(cuda, d, symmetric, dtype, tol):
    """Ragged frontiers, mb != m (a multiple of the store vector, and not), D below, at and past a chunk.

    Values are at most v + sigma^2 = 0.85; the global diagonal of a symmetric tile is bitwise v + sigma^2.
    """
    gen = torch.Generator().manual_seed(13)
    p = km.SEKernelParams(1.3, 0.8, 0.05)
    for t, m, mb in ((3, 100, 60), (2, 130, 45), (4, 256, 256)):
        xa = (torch.randn(t, m, d, generator=gen, dtype=dtype) / d**0.5).to(cuda)
        xb = xa[:, :mb].contiguous()
        row0 = torch.arange(t) * m
        col0 = torch.arange(t) * m if symmetric else (torch.arange(t) % 2) * m
        nvr, nvc = t * m - 13, t * m - 29
        ops.reset_launch_counts()
        got = ops.cov_tiles(xa, xb, row0.to(cuda), col0.to(cuda), nvr, nvc, p, symmetric=symmetric)
        torch.cuda.synchronize()
        assert ops.launch_counts()["cov_tiles"] == 1 and got.shape == (t, m, mb) and got.dtype == dtype
        want = cov_assembly.cov_tiles_plain(xa, xb, row0.to(cuda), col0.to(cuda), nvr, nvc, p, symmetric=symmetric)
        assert (got - want).abs().max() <= tol
        if symmetric:
            gi = row0[:, None] + torch.arange(mb)  # the diagonal of tile t: rows = cols < mb
            on = (gi < nvr) & (gi < nvc)
            diag = torch.diagonal(got[:, :mb, :mb], dim1=-2, dim2=-1).cpu()[on]
            assert torch.equal(diag, torch.full_like(diag, 0.8 + 0.05))


def test_grad_lowrank_nlml_on_the_card_matches_cpu(cuda):
    """The low-rank NLML's gradient in the hyperparameters, through every kernel of the build on the card.

    float32 within 1e-4 of the largest component; float64 each component within 1e-8 of its own size.
    """
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(1024, 4, generator=gen) / 2
    y = torch.sin(x.sum(-1))

    def grads(device, dtype=torch.float32):
        p = [torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for v in (1.0, 1.0, 0.1)]
        st = lowrank.lowrank_state(x, y, km.SEKernelParams(*p), 128, 64, dtype=dtype, device=device)
        return [g.cpu() for g in torch.autograd.grad(lowrank.nlml_from_lowrank_state(st), p)]

    ops.reset_launch_counts()
    got = grads(cuda)
    counts = ops.launch_counts()
    want = grads("cpu")
    assert all(counts[k] > 0 for k in ("cov_tiles", "potrf", "trsm", "trail", "lrgemm")), counts
    scale = max(float(w.abs()) for w in want)
    assert max(float((g - w).abs()) for g, w in zip(got, want)) <= 1e-4 * scale
    for g, w in zip(grads(cuda, torch.float64), grads("cpu", torch.float64)):
        assert float((g - w).abs()) <= 1e-8 * max(1.0, float(w.abs()))


def test_grad_tiled_logdet_on_the_card_matches_cpu(cuda):
    """d log det K / dK through the tiled Cholesky (POTRF, TRSM, TRAIL kernels), float32."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(512, 4, generator=gen)
    k = km.assemble_covariance(x, km.SEKernelParams(1.0, 1.0, 0.5))

    def grad(device):
        kd = k.to(device).requires_grad_()
        lp = executor.run_cholesky(tiling.pack_lower(kd, 64), device=device)
        return torch.autograd.grad(triangular.logdet_from_factor(lp, 8), kd)[0].cpu()

    ops.reset_launch_counts()
    got = grad(cuda)
    assert ops.launch_counts()["trail"] > 0
    want = grad("cpu")
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_ops_without_a_backward_raise_under_grad(cuda):
    w, l, y = (torch.randn(2, 32, 32, device=cuda) for _ in range(3))
    c = torch.eye(32, device=cuda).expand(2, 32, 32).contiguous()
    with pytest.raises(RuntimeError, match="carry_update"):
        ops.carry_update(w.requires_grad_(), l, y, c)
    with torch.no_grad():
        assert ops.carry_update(w, l, y, c).grad_fn is None
    # flash takes gradients (the language model trains through it): the kernel forward, the plain version's
    # autograd backward
    q, k, v = (torch.randn(1, 64, 2, 32, device=cuda) for _ in range(3))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k.requires_grad_(), v)
    assert out.grad_fn is not None and ops.launch_counts()["flash_attention"] == 1


def test_gp_leaves_the_callers_tf32_flags(cuda):
    """A GP on the card computes in IEEE float32 and gives the caller's TF32 flags back."""
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(300, 4, generator=gen)
    y = torch.sin(x.sum(-1))
    xt = torch.randn(50, 4, generator=gen)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32)
    try:
        results = []
        for flags in ((True, True), (False, False)):
            matmul.allow_tf32, cudnn.allow_tf32 = flags
            gp = GaussianProcess(x, y, tile_size=64, device=cuda)
            results.append(gp.predict_with_uncertainty(xt))
            assert (matmul.allow_tf32, cudnn.allow_tf32) == flags
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_nonpositive_pivot_gives_nan(cuda):
    a = torch.eye(40, device=cuda).unsqueeze(0).clone()
    a[0, 35, 35] = -1.0
    out = ops.potrf(a)
    torch.cuda.synchronize()
    assert torch.isnan(out[0, 35, 35])


def _spd_stack(g, m, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    r = torch.randn(g, m, m, generator=gen, dtype=dtype)
    return r @ r.mT / m + torch.eye(m, dtype=dtype)


@pytest.mark.parametrize(
    "dtype,g,m,tol",
    [(torch.float32, 1, 512, 1e-4), (torch.float32, 1, 1024, 1e-4), (torch.float32, 31, 512, 1e-4),
     (torch.float64, 1, 512, 1e-10), (torch.float32, 3, 77, 1e-4), (torch.float64, 2, 33, 1e-10)],
)
def test_potrf_matches_plain(cuda, dtype, g, m, tol):
    """The blocked multi-SM kernel against the unblocked plain loop (tolerance 1e-4 m / 1e-10 m)."""
    a = _spd_stack(g, m, dtype, 4).to(cuda)
    ops.reset_launch_counts()
    got = ops.potrf(a)
    torch.cuda.synchronize()
    assert ops.launch_counts()["potrf"] == 1
    assert got.dtype == dtype and got.shape == (g, m, m)
    assert (got - potrf_tile.potrf_plain(a)).abs().max() <= tol * m
    assert bool((torch.triu(got, 1) == 0).all())


def test_potrf_nonpositive_pivot_in_last_block_column(cuda):
    m, pivot = 512, 500
    a = _spd_stack(1, m, torch.float32, 5)
    a[0, pivot, pivot] = -1.0  # the Schur complement at the pivot is negative
    a = a.to(cuda)
    got = ops.potrf(a)
    torch.cuda.synchronize()
    want = potrf_tile.potrf_plain(a)
    assert torch.isnan(got[0, pivot, pivot])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert (got[0, :pivot] - want[0, :pivot]).abs().max() <= 1e-4 * m


@pytest.mark.parametrize("g,m", [(1, 512), (31, 512)])
def test_potrf_is_deterministic(cuda, g, m):
    a = _spd_stack(g, m, torch.float32, 6).to(cuda)
    assert torch.equal(ops.potrf(a), ops.potrf(a))


def test_gp_tiled_matches_monolithic_on_the_card(cuda):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(300, 4, generator=gen)
    y = torch.sin(x.sum(-1))
    xt = torch.randn(77, 4, generator=gen)
    ops.reset_launch_counts()
    mean, var = GaussianProcess(x, y, tile_size=64, device=cuda).predict_with_uncertainty(xt)
    ref_mean, ref_var = GaussianProcess(
        x, y, pipeline="monolithic", device=cuda
    ).predict_with_uncertainty(xt)
    assert (mean - ref_mean).abs().max() <= 1e-3
    assert (var - ref_var).abs().max() <= 1e-3
    counts = ops.launch_counts()
    assert counts["potrf"] == 5 and counts["cov_tiles"] == 3


BF16_FLASH_CASES = (
    # every head size, H / KV = 2 (one CTA takes both query heads of a KV head), softcap
    [(torch.bfloat16, 2, 77, 77, 8, 4, hd, True, 50.0, None, 2e-2, 1.0) for hd in (16, 32, 64, 128)]
    # H / KV = 1 (128 rows of one head a CTA) and 16 (pairs of heads), S != T both ways, ragged S and T
    + [(torch.bfloat16, 1, 200, 333, 4, 4, 128, True, None, None, 2e-2, 1.0),
       (torch.bfloat16, 2, 333, 200, 16, 1, 64, True, 50.0, None, 2e-2, 1.0),
       (torch.bfloat16, 1, 190, 100, 2, 1, 256, True, None, 50, 2e-2, 1.0),
       (torch.bfloat16, 2, 100, 190, 8, 4, 256, False, None, None, 2e-2, 1.0),
       (torch.bfloat16, 1, 129, 129, 3, 1, 32, True, 30.0, None, 2e-2, 1.0)]
    # a window of 1 and one as long as S; q x 20, so that the softcap bites
    + [(torch.bfloat16, 1, 130, 130, 8, 4, 256, True, 50.0, 1, 2e-2, 1.0),
       (torch.bfloat16, 1, 130, 130, 8, 4, 256, True, 50.0, 130, 2e-2, 1.0),
       (torch.bfloat16, 2, 256, 256, 8, 4, 256, True, 50.0, None, 2e-2, 20.0),
       (torch.bfloat16, 1, 300, 300, 2, 2, 64, True, 30.0, 100, 2e-2, 20.0)]
)


@pytest.mark.parametrize(
    "dtype,b,s,t,h,kv,hd,causal,softcap,window,tol,q_scale",
    [(torch.float32, 2, 100, 100, 4, 2, 16, True, 10.0, None, 5e-5, 1.0),
     (torch.float32, 1, 96, 192, 2, 1, 64, False, None, None, 5e-5, 1.0),
     (torch.float32, 1, 130, 130, 2, 2, 128, True, None, 37, 5e-5, 1.0),
     (torch.bfloat16, 2, 77, 77, 8, 4, 256, True, 50.0, None, 2e-2, 1.0),
     (torch.bfloat16, 1, 300, 300, 8, 4, 256, True, 50.0, 100, 2e-2, 1.0),
     (torch.bfloat16, 1, 64, 64, 4, 4, 32, True, None, 1, 2e-2, 1.0)]
    + BF16_FLASH_CASES,
)
def test_flash_attention_matches_plain(cuda, dtype, b, s, t, h, kv, hd, causal, softcap, window, tol, q_scale):
    """Ragged S, S != T, every head size, H / KV of 1, 2, 3 and 16, softcap and window.

    Tolerance per unit of max(1, |o|): bf16 rounds P (tensor cores) and the
    output (one ulp is up to 2^-7 |o|); float32 sums in another order.
    """
    gen = torch.Generator().manual_seed(6)
    q = (torch.randn(b, s, h, hd, generator=gen) * q_scale).to(cuda, dtype)
    k, v = (torch.randn(b, t, kv, hd, generator=gen).to(cuda, dtype) for _ in range(2))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, softcap=softcap, window=window).float()
    assert ((got.float() - want).abs() / want.abs().clamp_min(1.0)).max() <= tol
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :8].contiguous(), k[..., :8].contiguous(), v[..., :8].contiguous())


def test_gemma2_two_layers_full_width_prefill_on_the_card_matches_cpu(cuda):
    """gemma2-2b at full width cut to two layers (one local, one global), float32, S > the window cut to 64."""
    cfg = dataclasses.replace(configs.get_config("gemma2-2b"), n_layers=2, window=64,
                              param_dtype="float32", activation_dtype="float32")
    model = tf.init_model(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=torch.Generator().manual_seed(7))
    want, want_caches = tf.prefill_fn(model, cfg, toks, cache_len=103)
    ops.reset_launch_counts()
    got, caches = tf.prefill_fn(model.to(cuda), cfg, toks.to(cuda), cache_len=103)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 2
    assert (got.cpu() - want).abs().max() <= 1e-3
    assert [c["k"].shape[1] for c in caches] == [64, 103]
    for c, w in zip(caches, want_caches):
        assert (c["k"].cpu() - w["k"]).abs().max() <= 1e-3


# ---------------------------------------------------------------------------
# The kernel zoo and hyperparameter training on the card
# ---------------------------------------------------------------------------


def _zoo_cell(name):
    """(kernel, params) of a cell of the reference's zoo, with params away from the defaults."""
    se, m52 = km.SEKernelParams(1.3, 0.8, 0.05), km.SEKernelParams(0.7, 1.2, 0.05)
    return {
        "se": (km.SquaredExponential(), se),
        "matern12": (km.Matern12(), se),
        "matern32": (km.Matern32(), m52),
        "matern52": (km.Matern52(), m52),
        "rq": (km.RationalQuadratic(), km.RQKernelParams(1.1, 0.9, 0.05, 0.7)),
        "se_ard": (km.ARDSquaredExponential(), km.ARDKernelParams(torch.tensor([1.4]), 0.9, 0.05)),
        "white": (km.White(), km.WhiteKernelParams(0.2)),
        "se_ard2": (km.ARDSquaredExponential(ndim=2), km.ARDKernelParams(torch.tensor([0.7, 1.6]), 1.1, 0.05)),
        "scaled_m52": (km.Scaled(km.Matern52()), km.ScaledParams(1.7, m52)),
        "sum_m52_white": (km.Sum(km.Scaled(km.Matern52()), km.White()),
                          (km.ScaledParams(1.7, m52), km.WhiteKernelParams(0.2))),
        "prod_se_m32": (km.Product(km.SquaredExponential(), km.Matern32()), (se, m52)),
        # mixed distances: one launch per distance, combined by the wrapper
        "sum_ard2_m52": (km.Sum(km.ARDSquaredExponential(ndim=2), km.Matern52()),
                         (km.ARDKernelParams(torch.tensor([0.7, 1.6]), 1.1, 0.05), m52)),
    }[name]


ZOO_CELLS = ["se", "matern12", "matern32", "matern52", "rq", "se_ard", "white", "se_ard2", "scaled_m52",
             "sum_m52_white", "prod_se_m32", "sum_ard2_m52"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("name", ZOO_CELLS)
def test_cov_tiles_zoo_matches_plain(cuda, name, symmetric, dtype):
    """Every family and composite against the plain tile, at the kernel's stated tolerance.

    D = 2 (ARD's cells) or 3, ragged frontiers, mb != m; the global diagonal of a symmetric tile is
    bitwise diag + noise.  One ops call is one counted launch, or one per distance where a composite
    mixes an ARD distance with the isotropic one.
    """
    kern, p = _zoo_cell(name)
    d = 2 if "ard2" in name else 3
    gen = torch.Generator().manual_seed(ZOO_CELLS.index(name))
    for t, m, mb in ((3, 100, 60), (2, 130, 45)):
        xa = (torch.randn(t, m, d, generator=gen, dtype=dtype) / d**0.5).to(cuda)
        xb = xa[:, :mb].contiguous()
        row0 = (torch.arange(t) * m).to(cuda)
        col0 = row0 if symmetric else ((torch.arange(t) % 2) * m).to(cuda)
        nvr, nvc = t * m - 13, t * m - 29
        ops.reset_launch_counts()
        got = ops.cov_tiles(xa, xb, row0, col0, nvr, nvc, p, symmetric=symmetric, kernel=kern)
        torch.cuda.synchronize()
        launches = 2 if name == "sum_ard2_m52" else 1
        assert ops.launch_counts()["cov_tiles"] == launches and got.shape == (t, m, mb) and got.dtype == dtype
        want = cov_assembly.cov_tiles_plain(xa, xb, row0, col0, nvr, nvc, p, symmetric=symmetric, kernel=kern)
        assert (got - want).abs().max() <= cov_assembly.cov_tiles_tolerance(kern, p, xa[0], xb[0])
        if symmetric:
            pc = km.concrete_params(p)
            dv = torch.tensor(float(kern.diag(pc)) + float(kern.noise(pc)), dtype=dtype)
            gi = row0.cpu()[:, None] + torch.arange(mb)
            on = (gi < nvr) & (gi < nvc)
            diag = torch.diagonal(got[:, :mb, :mb], dim1=-2, dim2=-1).cpu()[on]
            assert torch.equal(diag, dv.expand_as(diag))


def _train_data(n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 3, generator=gen) / 2
    return x, torch.sin(x.sum(-1)) + 0.1 * torch.randn(n, generator=gen)


@pytest.mark.parametrize("name,vjp", [("se", "custom"), ("matern52", "custom"), ("matern52", "autodiff"),
                                      ("sum_m52_white", "autodiff")])
def test_nlml_tiled_grad_on_the_card_matches_cpu(cuda, name, vjp):
    """The tiled NLML and its gradient (n = 600, tile 128, padded) through cov_tiles, POTRF, TRSM and TRAIL."""
    x, y = _train_data(600, 3)
    kern, p0 = _zoo_cell(name)

    def grads(device):
        leaves, treedef = km.tree_flatten(p0)
        live = [torch.tensor(float(l), device=device, requires_grad=True) for l in leaves]
        val = mll.nlml_tiled(x, y, km.tree_unflatten(treedef, live), tile_size=128, vjp=vjp, kernel=kern,
                             device=device)
        return float(val.detach()), [float(g) for g in torch.autograd.grad(val, live, allow_unused=True)]

    ops.reset_launch_counts()
    v_card, g_card = grads(cuda)
    counts = ops.launch_counts()
    v_cpu, g_cpu = grads("cpu")
    assert all(counts[k] > 0 for k in ("cov_tiles", "potrf", "trsm", "trail")), counts
    assert v_card == pytest.approx(v_cpu, rel=1e-5)
    scale = max(abs(g) for g in g_cpu)
    assert max(abs(a - b) for a, b in zip(g_card, g_cpu)) <= 1e-4 * scale


def test_gp_optimize_on_the_card_matches_cpu(cuda):
    """Five Adam steps of a matern52 GP (n = 512, tile 128) on the card and on the CPU."""
    x, y = _train_data(512, 4)
    gps = [GaussianProcess(x, y, tile_size=128, kernel="matern52", device=dev) for dev in (cuda, "cpu")]
    for gp in gps:
        gp.optimize(steps=5, lr=0.05)
    for a, b in zip(km.tree_leaves(gps[0].params), km.tree_leaves(gps[1].params)):
        assert float(a) == pytest.approx(float(b), rel=1e-4)
    assert float(gps[0].nlml()) == pytest.approx(float(gps[1].nlml()), rel=1e-5)


def test_nlml_lowrank_grad_on_the_card_matches_cpu(cuda):
    """The blocked low-rank rule (n = 2048, m_inducing 256, tile 128) through cov_tiles and LRGEMM."""
    x, y = _train_data(2048, 5)

    def grads(device, dtype):
        p = [torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for v in (1.0, 1.0, 0.1)]
        val = mll.nlml_lowrank(x, y, km.SEKernelParams(*p), m_inducing=256, tile_size=128, dtype=dtype,
                               device=device)
        return [float(g) for g in torch.autograd.grad(val, p)]

    ops.reset_launch_counts()
    got = grads(cuda, torch.float32)
    assert ops.launch_counts()["lrgemm"] > 0 and ops.launch_counts()["cov_tiles"] > 0
    want = grads("cpu", torch.float32)
    scale = max(abs(w) for w in want)
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-4 * scale
    for a, b in zip(grads(cuda, torch.float64), grads("cpu", torch.float64)):
        assert abs(a - b) <= 1e-8 * max(1.0, abs(b))


# ---------------------------------------------------------------------------
# Fleets: per-problem hyperparameters in cov_tiles, GPBatch and GPFleet on the card
# ---------------------------------------------------------------------------


def _per_problem(p, b):
    """Each tensor-able leaf of ``p`` as a (b,) tensor spread around its value (ARD (D,) leaves: (b, D))."""
    scale = torch.linspace(0.6, 1.5, b, dtype=torch.float64)

    def spread(leaf):
        leaf = torch.as_tensor(leaf, dtype=torch.float64)
        return leaf[None] * scale.reshape((b,) + (1,) * leaf.ndim)

    return km.tree_map(spread, p)


@pytest.mark.parametrize("problems", [1, 4])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("name", ZOO_CELLS)
def test_cov_tiles_per_problem_matches_plain(cuda, name, symmetric, problems):
    """Per-problem (B,) leaves (P = B rows of the kernel's table) and shared ones (P = 1) against the
    plain tile, over B = 4 problems' tiles with ragged per-tile frontiers, float32, at the stated tolerance."""
    kern, p = _zoo_cell(name)
    d = 2 if "ard2" in name else 3
    b, g, m = 4, 3, 96
    pp = km.tree_map(lambda l: l.to(torch.float32).to(cuda), _per_problem(p, b)) if problems > 1 else p
    gen = torch.Generator().manual_seed(100 + ZOO_CELLS.index(name))
    xa = (torch.randn(b * g, m, d, generator=gen) / d**0.5).to(cuda)
    xb = xa if symmetric else (torch.randn(b * g, m, d, generator=gen) / d**0.5).to(cuda)
    row0 = (torch.arange(g) * m).repeat(b).to(cuda)
    nv = torch.tensor([g * m, g * m - 50, 130, 7]).repeat_interleave(g).to(cuda)
    table = ops.cov_descriptor(kern, pp, d, torch.float32, cuda)
    assert table.problems == problems
    ops.reset_launch_counts()
    got = ops.cov_tiles(xa, xb, row0, row0, nv, nv, pp, symmetric=symmetric, kernel=kern, table=table)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cov_tiles"] == len(table.launches)
    want = cov_assembly.cov_tiles_plain(xa, xb, row0, row0, nv, nv, pp, symmetric=symmetric, kernel=kern)
    tol = max(cov_assembly.cov_tiles_tolerance(kern, km.gather_params(pp, i, kern) if problems > 1 else pp,
                                               xa[0], xb[0]) for i in range(b))
    assert (got - want).abs().max() <= tol


def _fleet_data(b, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, 3, generator=gen) / 2
    return x, torch.sin(x.sum(-1)) + 0.1 * torch.randn(b, n, generator=gen), torch.randn(b, 50, 3, generator=gen) / 2


@pytest.mark.parametrize("shared", [True, False])
def test_gpbatch_on_the_card_matches_single_gps(cuda, shared):
    """GPBatch (B = 3, n = 700, tile 128) cold and warm against a loop of single GPs on the card."""
    x, y, xt = _fleet_data(3, 700, 11)
    p = km.SEKernelParams(0.9, 1.0, 0.1) if shared else km.SEKernelParams(torch.tensor([0.6, 0.9, 1.4]), 1.0,
                                                                              torch.tensor([0.05, 0.1, 0.2]))
    ops.reset_launch_counts()
    fleet = GPBatch(x, y, params=p, tile_size=128, device=cuda)
    mean, var = fleet.predict_with_uncertainty(xt)
    warm = fleet.predict(xt)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("cov_tiles", "potrf", "trsm", "trail")), counts
    for i in range(3):
        gp = GaussianProcess(x[i], y[i], params=km.gather_params(p, i) if not shared else p, tile_size=128,
                             device=cuda)
        mi, vi = gp.predict_with_uncertainty(xt[i])
        assert (mean[i] - mi).abs().max() <= 1e-4 and (warm[i] - mi).abs().max() <= 1e-4
        assert (var[i] - vi).abs().max() <= 1e-4
    nl = fleet.nlml()
    for i in range(3):
        gp = GaussianProcess(x[i], y[i], params=km.gather_params(p, i) if not shared else p, tile_size=128,
                             device=cuda)
        assert float(nl[i]) == pytest.approx(float(gp.nlml()), rel=1e-5)


def test_gpfleet_on_the_card_matches_single_gps(cuda):
    """A ragged fleet (n = 40 ... 900, tile 128) and a migrating update against single GPs on the card."""
    gen = torch.Generator().manual_seed(12)
    ns = (40, 200, 300, 600, 900)
    xs = [torch.randn(n, 3, generator=gen) / 2 for n in ns]
    ys = [torch.sin(x.sum(-1)) for x in xs]
    xt = torch.randn(60, 3, generator=gen) / 2
    fleet = GPFleet(xs, ys, tile_size=128, device=cuda)
    mean, var = fleet.predict_with_uncertainty(xt)
    for i, (x, y) in enumerate(zip(xs, ys)):
        mi, vi = GaussianProcess(x, y, tile_size=128, device=cuda).predict_with_uncertainty(xt)
        assert (mean[i] - mi).abs().max() <= 1e-4 and (var[i] - vi).abs().max() <= 1e-4
    arrivals = [torch.randn(k, 3, generator=gen) / 2 for k in (100, 0, 300, 10, 0)]
    fleet.update(arrivals, [torch.sin(a.sum(-1)) for a in arrivals])
    assert all(bk.state is not None for bk in fleet._buckets.values())
    cold = GPFleet(fleet._xs, fleet._ys, tile_size=128, device=cuda)
    assert (fleet.predict(xt) - cold.predict(xt)).abs().max() <= 1e-4


def test_nlml_tiled_batched_grad_on_the_card_matches_cpu(cuda):
    """The batched blocked rule (B = 3, n = 512, tile 128) on the card against the CPU, per component."""
    x, y, _ = _fleet_data(3, 512, 13)

    def grads(device):
        p = [torch.tensor(v, device=device, requires_grad=True) for v in ([0.7, 1.0, 1.3], [1.0] * 3, [0.1] * 3)]
        val = mll.nlml_tiled_batched(x, y, km.SEKernelParams(*p), tile_size=128, device=device)
        return val.detach().cpu(), [g.cpu() for g in torch.autograd.grad(val.sum(), p)]

    ops.reset_launch_counts()
    v_card, g_card = grads(cuda)
    assert ops.launch_counts()["cov_tiles"] > 0
    v_cpu, g_cpu = grads("cpu")
    torch.testing.assert_close(v_card, v_cpu, rtol=1e-5, atol=0)
    for a, b in zip(g_card, g_cpu):
        assert ((a - b).abs() <= 1e-4 * b.abs().clamp(min=1.0)).all(), (a, b)


# ---------------------------------------------------------------------------
# Language-model training and the fleets' batch invariance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 1024])
def test_flash_backward_at_full_width_matches_plain(cuda, window):
    """gemma2-2b's attention shapes (8 on 4 heads, hd 256, softcap 50), bf16: the kernel forward's gradients
    are autograd of the plain version's, within the bf16 rounding of the forward they are taken through."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 2048, 8, 256, device=cuda, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(1, 2048, 4, 256, device=cuda, generator=gen).to(torch.bfloat16) for _ in range(2))
    cot = torch.randn(1, 2048, 8, 256, device=cuda, generator=gen).to(torch.bfloat16)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.flash_attention(*args, softcap=50.0, window=window), args, cot)
    assert ops.launch_counts()["flash_attention"] == 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention.flash_attention_plain(*ref, softcap=50.0, window=window), ref, cot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)  # the backward is the plain version's autograd on the same saved inputs


def test_gemma2_two_layers_full_width_train_step_on_the_card_matches_cpu(cuda):
    """One Adam step of gemma2-2b at full width cut to two layers, float32, 1 x 256 tokens: the card's loss and
    gradients against the CPU's."""
    from repro_torch.optim import Adam
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import loss_and_grads

    cfg = dataclasses.replace(configs.get_config("gemma2-2b"), n_layers=2, param_dtype="float32",
                              activation_dtype="float32")
    model = tf.init_model(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 257), generator=torch.Generator().manual_seed(3))
    inputs, labels = toks[:, :-1], toks[:, 1:]
    loss_cpu, g_cpu = loss_and_grads(model, cfg, inputs, labels)
    card = model.to(cuda)
    ops.reset_launch_counts()
    loss, grads = loss_and_grads(card, cfg, inputs.to(cuda), labels.to(cuda))
    assert ops.launch_counts()["flash_attention"] == 4  # forward and recompute, two layers
    assert abs(float(loss) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    for n, g in g_cpu.items():
        assert (grads[n].cpu() - g).abs().max() <= 1e-4 * g.abs().max() + 1e-6, n
    opt = Adam(learning_rate=1e-3)
    step, _ = make_train_step(cfg, opt)
    _, state, loss2 = step(card, opt.init(card), inputs.to(cuda), labels.to(cuda))
    assert torch.isfinite(loss2) and int(state["step"]) == 1


@pytest.mark.parametrize("uncertainty", [False, True])
def test_fleet_results_do_not_depend_on_the_problem_count(cuda, uncertainty):
    """A GPBatch of B problems and one of its first B/2: the shared problems' predictions and NLMLs bitwise equal."""
    gen = torch.Generator().manual_seed(5)
    x, y = torch.randn(8, 700, 4, generator=gen), torch.randn(8, 700, generator=gen)
    xt = torch.randn(8, 300, 4, generator=gen)

    def run(b):
        gp = GPBatch(x[:b], y[:b], tile_size=128, device=cuda)
        out = gp.predict_with_uncertainty(xt[:b]) if uncertainty else (gp.predict(xt[:b]),)
        out = (*out, gp.nlml())
        gp.update(x[:b, :100] + 3.0, y[:b, :100])
        return [t[:4].cpu() for t in out] + [gp.predict(xt[:b])[:4].cpu(), gp.nlml()[:4].cpu()]

    ops.reset_launch_counts()
    whole = run(8)
    assert ops.launch_counts()["tile_gemv"] > 0 and ops.launch_counts()["tile_trsv"] > 0
    for a, b in zip(whole, run(4)):
        assert torch.equal(a, b)


def test_lowrank_fleet_nlml_does_not_depend_on_the_problem_count(cuda):
    """The low-rank tier: a GPBatch of B problems and one of its first B/2 give the shared problems bitwise equal
    predictions and NLMLs."""
    gen = torch.Generator().manual_seed(6)
    x, y = torch.randn(8, 700, 4, generator=gen), torch.randn(8, 700, generator=gen)
    xt = torch.randn(8, 300, 4, generator=gen)

    def run(b):
        gp = GPBatch(x[:b], y[:b], tile_size=128, method="lowrank", m_inducing=256, device=cuda)
        return [t[:4].cpu() for t in (*gp.predict_with_uncertainty(xt[:b]), gp.nlml())]

    for a, b in zip(run(8), run(4)):
        assert torch.equal(a, b)


# tile_gemv / tile_trsv (csrc/tile_gemv_trsv.cu): tile sizes that reach every variant and load width (m = 77 and
# 129 are not multiples of a 16-byte vector; 1024 takes the solve's streaming variant), Z in {1, 3, 16}
TILE_VECTOR_MS = (16, 77, 100, 128, 129, 512, 1024)


def _gemv_operands(gen, z, g, q, m, n, dtype, cuda, transposed, offset=0, broadcast=False):
    """a (Z, G, Q, m, n) on the card (transposed: a column-major view), x (Z, G, Q, n) (broadcast: stride 0 over
    G); ``offset`` elements in front of a's storage move its base off 16 bytes (a sliced operand)."""
    shape = (z, g, q, n, m) if transposed else (z, g, q, m, n)
    base = torch.randn(shape, generator=gen, dtype=dtype) / n**0.5
    store = torch.empty(base.numel() + offset, dtype=dtype, device=cuda)
    a = store[offset:].view(shape)
    a.copy_(base)
    if transposed:
        a = a.mT
    x = torch.randn(z, 1 if broadcast else g, q, n, generator=gen, dtype=dtype).to(cuda)
    return a, (x.expand(-1, g, -1, -1) if broadcast else x)


def _gemv_expected_variant(a, x):
    from _tile_vector_maps import gemv_variant

    return gemv_variant(a.data_ptr(), x.data_ptr(), a.shape[3], a.shape[4], a.stride(), x.stride(), a.element_size())


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", TILE_VECTOR_MS)
def test_tile_gemv_matches_plain(cuda, m, dtype, transposed):
    """tile_gemv against its plain version at 1e-4 x scale (kernel.tile_gemv's tolerance), on every route and load
    width: Z = 1 aligned, Z = 3 with n % 4 != 0 and a broadcast x, Z = 16 with a base off 16 bytes, whose result
    is bitwise the aligned copy's (the load width changes how elements are fetched, not the sums)."""
    from repro_torch.kernels import tile_gemv_trsv as tv

    gen = torch.Generator().manual_seed(m)
    cases = ((1, 2, 2, m, 0, False), (3, 2, 1, m + 3, 0, True), (16, 1, 2, m, 1, False))
    for z, g, q, n, offset, broadcast in cases:
        a, x = _gemv_operands(gen, z, g, q, m, n, dtype, cuda, transposed, offset, broadcast)
        assert tv.gemv_variant(a, x) == _gemv_expected_variant(a, x)
        ops.reset_launch_counts()
        got = ops.tile_gemv(a, x)
        torch.cuda.synchronize()
        assert ops.launch_counts()["tile_gemv"] == 1
        want = tv.tile_gemv_plain(a, x)
        assert (got - want).abs().max() <= 1e-4 * max(1.0, float(want.abs().max()))
        if offset:
            aligned = a.mT.clone().mT if transposed else a.clone()
            assert tv.gemv_variant(a, x).endswith("scalar")
            assert tv.gemv_variant(aligned, x) == _gemv_expected_variant(aligned, x)
            assert tv.gemv_variant(aligned, x).endswith("vector") or m % 4
            assert torch.equal(ops.tile_gemv(aligned, x), got)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", TILE_VECTOR_MS)
def test_tile_trsv_matches_plain(cuda, m, dtype, transpose):
    """tile_trsv against its plain version, L with garbage above its diagonal (never read), Z in {1, 3, 16}; a base
    off 16 bytes (cp.async of single elements) gives the aligned copy's bits.  Tolerance 1e-4 x scale (the
    kernel's), 1e-3 x scale for a float32 solve at m >= 512; the plan is the mirror's (tests/_tile_vector_maps)."""
    from _tile_vector_maps import trsv_plan as mirror
    from repro_torch.kernels import tile_gemv_trsv as tv

    assert tv.trsv_plan(m, dtype) == mirror(m, torch.empty(0, dtype=dtype).element_size())
    tol = 1e-3 if dtype == torch.float32 and m >= 512 else 1e-4
    gen = torch.Generator().manual_seed(m + 1)
    for z, g, offset in ((1, 1, 0), (3, 2, 0), (16, 1, 1)):
        a = torch.randn(z, g, m, m, generator=gen, dtype=torch.float64) / m**0.5
        low = torch.linalg.cholesky(a @ a.mT + torch.eye(m, dtype=torch.float64)).to(dtype)
        low = low + torch.triu(torch.randn(z, g, m, m, generator=gen, dtype=dtype), 1)
        store = torch.empty(low.numel() + offset, dtype=dtype, device=cuda)
        l = store[offset:].view(low.shape)
        l.copy_(low)
        r = torch.randn(z, g, m, generator=gen, dtype=dtype).to(cuda)
        ops.reset_launch_counts()
        got = ops.tile_trsv(l, r, transpose)
        torch.cuda.synchronize()
        assert ops.launch_counts()["tile_trsv"] == 1
        want = tv.tile_trsv_plain(l, r, transpose)
        assert (got - want).abs().max() <= tol * max(1.0, float(want.abs().max()))
        if offset:
            assert torch.equal(ops.tile_trsv(l.clone(), r, transpose), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_trsv_streams_more_blocks_than_warps(cuda, dtype):
    """m = 2080: 65 blocks on a cluster of 8, so rank 0 owns 9 and its warp 0 solves two blocks, in the chain's
    order (the streaming variant); both directions against the plain version at the kernel's tolerance (1e-3 x
    scale in float32 at this m, 1e-4 x scale in float64)."""
    from repro_torch.kernels import tile_gemv_trsv as tv

    m = 2080
    assert tv.trsv_plan(m, dtype)["variant"] == "streaming"
    gen = torch.Generator().manual_seed(13)
    a = torch.randn(2, 1, m, m, generator=gen, dtype=torch.float64) / m**0.5
    low = torch.linalg.cholesky(a @ a.mT + torch.eye(m, dtype=torch.float64)).to(dtype).to(cuda)
    r = torch.randn(2, 1, m, generator=gen, dtype=dtype).to(cuda)
    tol = 1e-3 if dtype == torch.float32 else 1e-4
    for transpose in (False, True):
        got, want = ops.tile_trsv(low, r, transpose), tv.tile_trsv_plain(low, r, transpose)
        assert (got - want).abs().max() <= tol * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_kernels_do_not_depend_on_the_launch_width(cuda, dtype):
    """A problem's result bitwise the same with Z problems in the launch and with Z/2, and in a slice that starts
    elsewhere (a rank's share of a sharded fleet): both GEMV routes, both solve directions and variants."""
    gen = torch.Generator().manual_seed(11)
    for transposed in (False, True):
        a, x = _gemv_operands(gen, 16, 2, 2, 512, 512, dtype, cuda, transposed)
        whole = ops.tile_gemv(a, x)
        assert torch.equal(whole[:8], ops.tile_gemv(a[:8], x[:8]))
        assert torch.equal(whole[5:], ops.tile_gemv(a[5:], x[5:]))
    for m in (512, 1024):
        a = torch.randn(16, 1, m, m, generator=gen, dtype=torch.float64) / m**0.5
        low = torch.linalg.cholesky(a @ a.mT + torch.eye(m, dtype=torch.float64)).to(dtype).to(cuda)
        r = torch.randn(16, 1, m, generator=gen, dtype=dtype).to(cuda)
        for transpose in (False, True):
            whole = ops.tile_trsv(low, r, transpose)
            assert torch.equal(whole[:8], ops.tile_trsv(low[:8], r[:8], transpose))
            assert torch.equal(whole[5:], ops.tile_trsv(low[5:], r[5:], transpose))


def test_tile_trsv_past_its_sizes_raises(cuda):
    """No variant takes m past the streaming variant's barriers: the plan and the launch raise, nothing falls back."""
    from repro_torch.kernels import tile_gemv_trsv as tv

    with pytest.raises(ValueError):
        tv.trsv_plan(77856, torch.float64)
    l, r = torch.empty(1, 1, 1, 1, device=cuda), torch.empty(1, 1, 1, device=cuda)
    with pytest.raises(ValueError):
        tv.tile_trsv_cuda(l.expand(1, 1, 479264, 479264), r.expand(1, 1, 479264), False)
