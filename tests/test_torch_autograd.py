"""Gradients through the port's tile ops, and the TF32 scope of ``GaussianProcess``.

On the card each op's forward is its CUDA kernel, which autograd cannot see
into; ``ops._RefGrad`` gives it the backward of the op's differentiable
reference, as the JAX package's ``_with_ref_vjp`` does.  Here, on the CPU,
the "kernel" is the plain op run under ``no_grad`` on detached inputs, so
any gradient that comes out went through the helper.  The cases hold the
helper against plain autograd of the reference (float64, ``gradcheck``) and
against ``jax.vjp`` of the JAX package's own wrappers (float32, m = 16, the
Pallas kernels in interpret mode, the reference tests' float32 gradient
tolerance: rtol 1e-3, atol 1e-3 max|g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import gp as tgp
from repro_torch.core import kernels_math as tkm
from repro_torch.core import lowrank
from repro_torch.kernels import cov_assembly, lrgemm_tile, ops, potrf_tile, trailing_update, trsm_tile

PLAIN = {
    "potrf": potrf_tile.potrf_plain,
    "trsm": trsm_tile.trsm_plain,
    "trail": trailing_update.trail_plain,
    "lrgemm": lrgemm_tile.lrgemm_plain,
}


def detached(fn):
    """A stand-in for a CUDA kernel: the plain op on detached inputs, without autograd."""

    def kernel(*args):
        with torch.no_grad():
            return fn(*(a.detach() for a in args))

    return kernel


def through_helper(name):
    return lambda *args: ops._run(name, detached(PLAIN[name]), *args)


def _spd(rng, g, m):
    a = rng.standard_normal((g, m, m))
    return a @ np.swapaxes(a, -1, -2) + m * np.eye(m)


def _inputs(name, rng, g=2, m=6):
    """Seeded float64 operands of each op (lower factors where the op reads one)."""
    if name == "potrf":
        return (torch.from_numpy(_spd(rng, g, m)),)
    if name == "trsm":
        return torch.from_numpy(np.linalg.cholesky(_spd(rng, g, m))), torch.from_numpy(rng.standard_normal((g, m, m)))
    if name == "trail":
        return tuple(torch.from_numpy(rng.standard_normal((g, m, m))) for _ in range(3))
    kflat = torch.from_numpy(rng.standard_normal((g + 2, m, m + 3)))
    v = torch.from_numpy(rng.standard_normal((3, m + 3)))
    return kflat, v, torch.tensor([2, 0, 3][:g]), torch.tensor([1, 2, 0][:g])


# each op as a function of its differentiable operands; potrf and trsm read one triangle
ARGS = {
    "potrf": lambda f: (lambda a: f(0.5 * (a + a.mT))),
    "trsm": lambda f: (lambda l, b: f(torch.tril(l), b)),
    "trail": lambda f: (lambda c, a, b: f(c, a, b)),
    "lrgemm": None,
}


@pytest.mark.parametrize("name", ["potrf", "trsm", "trail", "lrgemm"])
def test_helper_passes_gradcheck(name):
    args = _inputs(name, np.random.default_rng(0))
    if name == "lrgemm":
        kflat, v, ia, ib = args
        fn = lambda k, x: through_helper("lrgemm")(k, x, ia, ib)
        diff = (kflat.requires_grad_(), v.requires_grad_())
    else:
        fn = ARGS[name](through_helper(name))
        diff = tuple(a.requires_grad_() for a in args)
    assert torch.autograd.gradcheck(fn, diff)


@pytest.mark.parametrize("name", ["potrf", "trsm", "trail", "lrgemm"])
def test_helper_matches_autograd_of_the_reference(name):
    rng = np.random.default_rng(1)
    args = _inputs(name, rng, g=3, m=8)
    n_diff = 2 if name == "lrgemm" else len(args)
    diff = [a.clone().requires_grad_() for a in args[:n_diff]]
    rest = list(args[n_diff:])
    out = ops._run(name, detached(PLAIN[name]), *diff, *rest)
    cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)))
    got = torch.autograd.grad(out, diff, cot)
    ref_in = [a.clone().requires_grad_() for a in args[:n_diff]]
    want = torch.autograd.grad(ops.GRAD_REFS[name](*ref_in, *rest), ref_in, cot)
    assert out.grad_fn is not None
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-12, atol=1e-12)
    # the forward is the kernel's own result
    torch.testing.assert_close(out.detach(), PLAIN[name](*args), rtol=0, atol=0)


def test_no_grad_or_no_operand_needing_grad_calls_the_kernel_alone():
    calls = []

    def kernel(*args):
        calls.append(torch.is_grad_enabled())
        return trailing_update.trail_plain(*args)

    c, a, b = _inputs("trail", np.random.default_rng(2))
    out = ops._run("trail", kernel, c, a, b)
    assert out.grad_fn is None and calls == [True]
    with torch.no_grad():
        out = ops._run("trail", kernel, c, a, b.requires_grad_())
    assert out.grad_fn is None and calls == [True, False]
    out = ops._run("trail", kernel, c, a, b)  # through the helper: its forward runs without grad
    assert out.grad_fn is not None and calls == [True, False, False]


def test_trail_bf16_update_dtype_gradients():
    """update_dtype casts A and B outside the helper; the cast's backward brings the gradient home."""
    rng = np.random.default_rng(3)
    c, a, b = (torch.from_numpy(rng.standard_normal((2, 8, 8))).float().requires_grad_() for _ in range(3))
    cot = torch.from_numpy(rng.standard_normal((2, 8, 8))).float()
    bf = torch.bfloat16
    a_, b_ = a.to(bf), b.to(bf)
    out = ops._run("trail", detached(PLAIN["trail"]), c, a_, b_)
    got = torch.autograd.grad(out, (c, a, b), cot)
    want = torch.autograd.grad(trailing_update.trail_plain(c, a.to(bf), b.to(bf)), (c, a, b), cot)
    assert all(g.dtype == torch.float32 for g in got)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


def test_tiled_logdet_gradient_on_the_cpu():
    """The executor's tiled Cholesky is differentiable end to end: d logdet K / dK = K^-1 (symmetrized)."""
    from repro_torch.core import executor, tiling, triangular

    rng = np.random.default_rng(4)
    k = torch.from_numpy(_spd(rng, 1, 24)[0]).requires_grad_()
    lp = executor.run_cholesky(tiling.pack_lower(k, 8), device="cpu")
    (g,) = torch.autograd.grad(triangular.logdet_from_factor(lp, 3), k)
    torch.testing.assert_close(0.5 * (g + g.T), torch.linalg.inv(k.detach()), rtol=1e-10, atol=1e-12)


def test_lowrank_nlml_gradient_matches_finite_differences():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((120, 3)))
    y = torch.sin(x.sum(-1))
    base = (1.3, 0.9, 0.1)

    def nlml(vals):
        p = tkm.SEKernelParams(*vals)
        return lowrank.nlml_from_lowrank_state(
            lowrank.lowrank_state(x, y, p, 40, 16, dtype=torch.float64, device="cpu"))

    p = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in base]
    g = torch.autograd.grad(nlml(p), p)
    for i in range(3):
        hi, lo = list(base), list(base)
        hi[i] += 1e-6
        lo[i] -= 1e-6
        fd = (float(nlml(hi)) - float(nlml(lo))) / 2e-6
        assert float(g[i]) == pytest.approx(fd, rel=1e-5)


# ---------------------------------------------------------------------------
# against jax.vjp of the JAX package's wrappers (Pallas in interpret mode)
# ---------------------------------------------------------------------------


def _jax_vjp(fn, args, cot):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_grads(name, args, cot, rest=()):
    diff = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = ops._run(name, detached(PLAIN[name]), *diff, *rest)
    return [g.numpy() for g in torch.autograd.grad(out, diff, torch.from_numpy(cot))]


def _close(got, want):
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, w_, rtol=1e-3, atol=1e-3 * np.abs(w_).max())


M = 16


def test_potrf_gradient_matches_jax():
    rng = np.random.default_rng(6)
    a = _spd(rng, 1, M)[0].astype(np.float32)
    cot = np.tril(rng.standard_normal((M, M))).astype(np.float32)
    _close(_port_grads("potrf", [a[None]], cot[None]), [g[None] for g in _jax_vjp(jops.potrf, [a], cot)])


def test_trsm_gradient_matches_jax():
    rng = np.random.default_rng(7)
    l = np.linalg.cholesky(_spd(rng, 1, M)[0]).astype(np.float32)
    b = rng.standard_normal((M, M)).astype(np.float32)
    cot = rng.standard_normal((M, M)).astype(np.float32)
    got = _port_grads("trsm", [l[None], b[None]], cot[None])
    want = _jax_vjp(jops.trsm, [l, b], cot)
    _close([got[0][0] * np.tril(np.ones((M, M))), got[1][0]], [want[0] * np.tril(np.ones((M, M))), want[1]])


def test_gemm_gradient_matches_jax():
    rng = np.random.default_rng(8)
    c, a, b, cot = (rng.standard_normal((M, M)).astype(np.float32) for _ in range(4))
    want = _jax_vjp(jops.gemm, [c, a, b], cot)
    _close([g[0] for g in _port_grads("trail", [c[None], a[None], b[None]], cot[None])], want)


def test_syrk_gradient_matches_jax():
    """SYRK passes one panel tile as A and B; its two gradients add up."""
    rng = np.random.default_rng(9)
    c, a, cot = (rng.standard_normal((M, M)).astype(np.float32) for _ in range(3))
    want = _jax_vjp(jops.syrk, [c, a], cot)
    ct, at = (torch.from_numpy(v[None]).requires_grad_() for v in (c, a))
    out = ops._run("trail", detached(PLAIN["trail"]), ct, at, at)
    got = [g[0].numpy() for g in torch.autograd.grad(out, (ct, at), torch.from_numpy(cot[None]))]
    _close(got, want)


def test_lrgemm_gradient_matches_jax():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((M, M + 4)).astype(np.float32)
    v = rng.standard_normal(M + 4).astype(np.float32)
    cot = rng.standard_normal(M).astype(np.float32)
    want = _jax_vjp(jops.lrgemm, [a, v], cot)
    idx = torch.zeros(1, dtype=torch.int64)
    got = _port_grads("lrgemm", [a[None], v[None]], cot[None], rest=(idx, idx))
    _close([got[0][0], got[1][0]], want)


# ---------------------------------------------------------------------------
# cov_tiles: the kernel reads the hyperparameters as floats
# ---------------------------------------------------------------------------


@pytest.fixture
def cov_on_card(monkeypatch):
    """``ops.cov_tiles`` on its card route, with the plain tile, detached, as the kernel.

    The stand-in counts its call as the CUDA wrapper counts its launch.
    """
    calls = []
    launcher = ops._cov.cov_tiles_cuda

    def kernel(xa, xb, *args, **kw):
        calls.append(torch.is_grad_enabled())
        launcher.launches += 1
        return _cov_detached(xa, xb, *args, **kw)

    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(ops._cov, "cov_tiles_cuda", kernel)
    ops.reset_launch_counts()
    return calls


def _cov_detached(xa, xb, row0, col0, nvr, nvc, params, **kw):
    with torch.no_grad():
        p = tkm.SEKernelParams(*(v.detach() if isinstance(v, torch.Tensor) else v
                                 for v in (params.lengthscale, params.vertical, params.noise)))
        return cov_assembly.cov_tiles_plain(xa.detach(), xb.detach(), row0, col0, nvr, nvc, p, **kw)


def _cov_case(rng, tensor_fields):
    xa = torch.from_numpy(rng.standard_normal((3, 6, 2)))
    xb = torch.from_numpy(rng.standard_normal((3, 5, 2)))
    vals = dict(lengthscale=1.3, vertical=0.8, noise=0.2)
    params = tkm.SEKernelParams(**{k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
                                   if k in tensor_fields else v for k, v in vals.items()})
    return xa, xb, params


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("tensor_fields", [("lengthscale", "vertical", "noise"), ("lengthscale", "noise")])
def test_cov_tiles_card_route_keeps_hyperparameter_gradients(cov_on_card, symmetric, tensor_fields):
    """The kernel runs once (counted) under the helper; the gradients are autograd's of the plain tile."""
    rng = np.random.default_rng(12)
    xa, xb, params = _cov_case(rng, tensor_fields)
    xb = xa[:, :5] if symmetric else xb
    row0, col0 = torch.tensor([0, 6, 12]), torch.tensor([0, 0, 6])
    out = ops.cov_tiles(xa, xb, row0, col0, 16, 14, params, symmetric=symmetric)
    assert cov_on_card == [False] and ops.launch_counts()["cov_tiles"] == 1 and out.grad_fn is not None
    want_out = cov_assembly.cov_tiles_plain(xa, xb, row0, col0, 16, 14, params, symmetric=symmetric)
    torch.testing.assert_close(out.detach(), want_out.detach(), rtol=0, atol=0)
    used = [f for f in tensor_fields if symmetric or f != "noise"]  # cross tiles do not read the noise
    wrt = [getattr(params, f) for f in used]
    cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)))
    got = torch.autograd.grad(out, wrt, cot)
    want = torch.autograd.grad(want_out, wrt, cot)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-12, atol=1e-12)

    def fn(*values):
        p = tkm.SEKernelParams(**{**{k: getattr(params, k) for k in ("lengthscale", "vertical", "noise")},
                                  **dict(zip(used, values))})
        return ops.cov_tiles(xa, xb, row0, col0, 16, 14, p, symmetric=symmetric)

    assert torch.autograd.gradcheck(fn, tuple(wrt))


def test_cov_tiles_card_route_without_grad_calls_the_kernel_alone(cov_on_card):
    xa, xb, params = _cov_case(np.random.default_rng(13), ("lengthscale",))
    with torch.no_grad():
        out = ops.cov_tiles(xa, xb, 0, 0, 6, 5, params, symmetric=False)
    plain = ops.cov_tiles(xa, xb, 0, 0, 6, 5, params.as_floats(), symmetric=False)
    assert out.grad_fn is None and plain.grad_fn is None and cov_on_card == [False, True]
    assert ops.launch_counts()["cov_tiles"] == 2


# ---------------------------------------------------------------------------
# the TF32 scope of GaussianProcess
# ---------------------------------------------------------------------------


@pytest.fixture
def tf32_flags():
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (m.allow_tf32, c.allow_tf32)
    yield m, c
    m.allow_tf32, c.allow_tf32 = before


def test_ieee_matmul_scope_sets_and_restores_the_matmul_flag(tf32_flags):
    matmul, cudnn = tf32_flags
    for caller in (True, False):
        matmul.allow_tf32, cudnn.allow_tf32 = caller, True
        with tgp.ieee_float32_matmul("cuda"):
            assert matmul.allow_tf32 is False
            assert cudnn.allow_tf32 is True
        assert matmul.allow_tf32 is caller and cudnn.allow_tf32 is True
    matmul.allow_tf32, cudnn.allow_tf32 = True, False
    with pytest.raises(ZeroDivisionError):
        with tgp.ieee_float32_matmul(torch.device("cuda", 0)):
            assert matmul.allow_tf32 is False
            1 / 0
    assert matmul.allow_tf32 is True and cudnn.allow_tf32 is False


def test_ieee_matmul_scope_with_the_newer_precision_api():
    """A caller who set ``fp32_precision`` (reading the legacy flag then raises) gets it back.

    In a subprocess: mixing the two APIs leaves process-wide state behind.
    """
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from repro_torch.core import gp\n"
        "m = torch.backends.cuda.matmul\n"
        "m.fp32_precision = 'tf32'\n"
        "with gp.ieee_float32_matmul('cuda'):\n"
        "    assert m.fp32_precision == 'ieee', m.fp32_precision\n"
        "assert m.fp32_precision == 'tf32', m.fp32_precision\n"
        "print('ok')\n"
    )
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_ieee_matmul_scope_leaves_the_cpu_alone(tf32_flags):
    matmul, _ = tf32_flags
    matmul.allow_tf32 = True
    with tgp.ieee_float32_matmul("cpu"):
        assert matmul.allow_tf32 is True


def test_gaussian_process_calls_run_in_the_scope(tf32_flags, monkeypatch):
    """Each public call of a CUDA GP enters the scope once; a CPU GP touches no flag."""
    entered = []
    real = tgp.ieee_float32_matmul

    def spy(device):
        entered.append(torch.device(device).type)
        return real(device)

    monkeypatch.setattr(tgp, "ieee_float32_matmul", spy)
    matmul, cudnn = tf32_flags
    matmul.allow_tf32, cudnn.allow_tf32 = True, True
    rng = np.random.default_rng(11)
    x = rng.standard_normal((40, 2))
    gp = tgp.GaussianProcess(x, np.sin(x.sum(-1)), tile_size=16, device="cpu")
    gp.predict_with_uncertainty(x[:5])
    gp.update(x[:3], np.sin(x[:3].sum(-1)))
    assert entered and set(entered) == {"cpu"}
    assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
