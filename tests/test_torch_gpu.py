"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the ``repro`` package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.core import GaussianProcess
from repro_torch.core import kernels_math as km
from repro_torch.kernels import (
    carry_update, cov_assembly, lrgemm_tile, ops, potrf_tile, trailing_update, trsm_tile,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,m,tol", [(torch.float32, 100, 1e-3), (torch.float64, 64, 1e-10)])
def test_kernels_match_plain(cuda, dtype, m, tol):
    gen = torch.Generator().manual_seed(0)
    r = torch.randn(3, m, m, generator=gen, dtype=dtype)
    spd = (r @ r.mT / m + torch.eye(m, dtype=dtype)).to(cuda)
    rhs = torch.randn(3, m, m, generator=gen, dtype=dtype).to(cuda)
    lo = potrf_tile.potrf_plain(spd)
    ops.reset_launch_counts()
    assert (ops.potrf(spd) - lo).abs().max() <= tol * m
    assert (ops.trsm(lo, rhs) - trsm_tile.trsm_plain(lo, rhs)).abs().max() <= tol * m
    assert (ops.trail(spd, lo, rhs) - trailing_update.trail_plain(spd, lo, rhs)).abs().max() <= tol * m
    x = torch.randn(3, m, 3, generator=gen, dtype=dtype).to(cuda)
    p = km.SEKernelParams(1.3, 0.8, 0.05)
    for sym in (True, False):
        got = ops.cov_tiles(x, x, 0, 0, m - 5, m - 9, p, symmetric=sym)
        want = cov_assembly.cov_tiles_plain(x, x, 0, 0, m - 5, m - 9, p, symmetric=sym)
        assert (got - want).abs().max() <= tol
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "cov_tiles": 2, "potrf": 1, "trsm": 1, "trail": 1, "carry_update": 0, "lrgemm": 0,
    }


@pytest.mark.parametrize(
    "dtype,g,m,tol",
    [(torch.float32, 3, 512, 1e-3), (torch.float32, 4, 100, 1e-3), (torch.float64, 3, 77, 1e-10),
     (torch.float64, 2, 512, 1e-10)],
)
def test_carry_update_matches_plain(cuda, dtype, g, m, tol):
    """(W - L Y) C^{-T}: the kernel against its plain version, C = chol(I + R R^T / m)."""
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
    "dtype,g,m,mb,tol",
    [(torch.float32, 64, 512, 512, 1e-4), (torch.float32, 7, 100, 60, 1e-4),
     (torch.float32, 5, 77, 45, 1e-4), (torch.float64, 7, 100, 60, 1e-12),
     (torch.float64, 3, 512, 384, 1e-12), (torch.float64, 5, 33, 45, 1e-12)],
)
def test_lrgemm_matches_plain(cuda, dtype, g, m, mb, tol):
    """kflat[a[g]] @ v[b[g]]: odd G, mb != m, odd mb (the scalar path), both types."""
    gen = torch.Generator().manual_seed(4)
    kflat = torch.randn(g + 3, m, mb, generator=gen, dtype=dtype).to(cuda)
    v = torch.randn(4, mb, generator=gen, dtype=dtype).to(cuda)
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


def test_trail_bf16_operands(cuda):
    gen = torch.Generator().manual_seed(1)
    c, a, b = (torch.randn(5, 96, 96, generator=gen).to(cuda) for _ in range(3))
    bf = torch.bfloat16
    got = ops.trail(c, a, b, bf)
    want = trailing_update.trail_plain(c, a.to(bf), b.to(bf))
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-3


def test_nonpositive_pivot_gives_nan(cuda):
    a = torch.eye(40, device=cuda).unsqueeze(0).clone()
    a[0, 35, 35] = -1.0
    out = ops.potrf(a)
    torch.cuda.synchronize()
    assert torch.isnan(out[0, 35, 35])


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
