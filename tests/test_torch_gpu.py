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
from repro_torch.kernels import carry_update, cov_assembly, ops, potrf_tile, trailing_update, trsm_tile

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
    assert ops.launch_counts() == {"cov_tiles": 2, "potrf": 1, "trsm": 1, "trail": 1, "carry_update": 0}


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
