"""The port's kernel zoo against the JAX package's: every registered family and the composites.

The cells are the reference's ``tests/test_kernel_zoo.py::_zoo``: the seven
registered families, ARD on two features with distinct lengthscales, and the
``Scaled``, ``Sum`` and ``Product`` composites.  Inputs come from a numpy
seed and go through both packages; the Pallas assembly kernel runs in
interpret mode.  The CUDA kernel cannot run here, so its descriptor (what
``kernels/cov_assembly.py`` hands ``csrc/cov_assembly.cu``) is evaluated by a
rendition of the kernel's epilogue and held against the plain version.
Tolerances: float32 parity 1e-5 on values of at most ~1 (the same formula,
rounded in another order); float64 renditions 1e-12.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_math as jkm
from repro.core import predict as jpred
from repro.kernels import cov_assembly as jcov
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import convert
from repro_torch.core import GaussianProcess
from repro_torch.core import kernels_math as tkm
from repro_torch.kernels import cov_assembly, ops


def _pair(name):
    """(JAX kernel, port kernel) of a zoo cell."""
    if name in jkm.KERNEL_REGISTRY:
        return jkm.get_kernel(name), tkm.get_kernel(name)
    j, t = {
        "se_ard2": (jkm.ARDSquaredExponential(ndim=2), tkm.ARDSquaredExponential(ndim=2)),
        "scaled_m52": (jkm.Scaled(jkm.Matern52()), tkm.Scaled(tkm.Matern52())),
        "sum_m52_white": (jkm.Sum(jkm.Scaled(jkm.Matern52()), jkm.White()),
                          tkm.Sum(tkm.Scaled(tkm.Matern52()), tkm.White())),
        "prod_se_m32": (jkm.Product(jkm.SquaredExponential(), jkm.Matern32()),
                        tkm.Product(tkm.SquaredExponential(), tkm.Matern32())),
    }[name]
    return j, t


ZOO = sorted(jkm.KERNEL_REGISTRY) + ["se_ard2", "scaled_m52", "sum_m52_white", "prod_se_m32"]


def _leaves(name, kern_j, rng):
    """Seeded hyperparameter leaves (numpy), distinct from the defaults, in JAX's tree order."""
    import jax

    leaves = [np.asarray(l, np.float32) for l in jax.tree_util.tree_leaves(kern_j.default_params())]
    out = []
    for l in leaves:
        out.append((rng.uniform(0.6, 1.6, l.shape)).astype(np.float32))
    if name == "se_ard2":
        out[0] = np.asarray([0.7, 1.6], np.float32)
    return out


def _params(name, rng):
    import jax

    kern_j, kern_t = _pair(name)
    leaves = _leaves(name, kern_j, rng)
    treedef = jax.tree_util.tree_structure(kern_j.default_params())
    pj = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(l) for l in leaves])
    return kern_j, kern_t, pj, convert.kernel_params_from_numpy(kern_t, leaves)


@pytest.mark.parametrize("name", ZOO)
def test_kfree_and_cov_tiles_match_the_reference(name):
    """kfree, and the masked tiles of both kinds against the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(ZOO.index(name))
    kern_j, kern_t, pj, pt = _params(name, rng)
    xa = rng.standard_normal((3, 32, 2)).astype(np.float32) / 1.5
    xb = rng.standard_normal((3, 24, 2)).astype(np.float32) / 1.5
    got = kern_t.kfree(pt, torch.from_numpy(xa[0]), torch.from_numpy(xb[0]))
    want = np.asarray(kern_j.kfree(pj, jnp.asarray(xa[0]), jnp.asarray(xb[0])))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    row0, col0 = np.array([0, 32, 64]), np.array([0, 0, 32])
    for sym, nvr, nvc in ((True, 80, 80), (False, 80, 70)):
        want = jcov.cov_tiles(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(row0), jnp.asarray(col0), kernel=kern_j,
                              params=pj, n_valid_r=nvr, n_valid_c=nvc, symmetric=sym, interpret=True)
        got = cov_assembly.cov_tiles_plain(torch.from_numpy(xa), torch.from_numpy(xb), torch.from_numpy(row0),
                                           torch.from_numpy(col0), nvr, nvc, pt, symmetric=sym, kernel=kern_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        assert float(tkm.resolve_kernel(kern_t).diag(tkm.concrete_params(pt))) == pytest.approx(
            float(kern_j.diag(jkm.concrete_params(pj))), rel=1e-6)


@pytest.mark.parametrize("name", ["se", "matern52"])
def test_kfree_vjp_matches_the_reference(name):
    rng = np.random.default_rng(5)
    kern_j, kern_t, pj, pt = _params(name, rng)
    xa, xb = rng.standard_normal((20, 3)).astype(np.float32), rng.standard_normal((15, 3)).astype(np.float32)
    xb[0] = xa[0]  # d2 == 0: Matérn 5/2's derivative stays finite there
    g = rng.standard_normal((20, 15)).astype(np.float32)
    gp_j, ga_j, gb_j = kern_j.kfree_vjp(pj, jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(g))
    gp_t, ga_t, gb_t = kern_t.kfree_vjp(pt, torch.from_numpy(xa), torch.from_numpy(xb), torch.from_numpy(g))
    import jax

    for a, b in zip(tkm.tree_leaves(gp_t), jax.tree_util.tree_leaves(gp_j)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ga_t.numpy(), np.asarray(ga_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gb_t.numpy(), np.asarray(gb_j), rtol=1e-4, atol=1e-4)
    # and against autograd of the port's own kfree
    leaves, treedef = tkm.tree_flatten(pt)
    live = [torch.tensor(float(l), dtype=torch.float64, requires_grad=True) for l in leaves]
    xa64, xb64 = (torch.from_numpy(a).double().requires_grad_() for a in (xa, xb))
    val = torch.sum(torch.from_numpy(g).double() * kern_t.kfree(tkm.tree_unflatten(treedef, live), xa64, xb64))
    auto = torch.autograd.grad(val, live[:2] + [xa64, xb64])
    gp64, ga64, gb64 = kern_t.kfree_vjp(tkm.tree_unflatten(treedef, [l.detach() for l in live]),
                                       xa64.detach(), xb64.detach(), torch.from_numpy(g).double())
    for a, b in zip([gp64.lengthscale, gp64.vertical, ga64, gb64], auto):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# The CUDA kernel's descriptor, evaluated as csrc/cov_assembly.cu evaluates it
# ---------------------------------------------------------------------------


def _kernel_rendition(ints, reals, d2):
    """The kernel's epilogue (float64 branch) in torch on a d2 tile, from the structure and one table row."""
    mt, mf = cov_assembly.MAX_TERMS, cov_assembly.MAX_FACTORS
    kind, n_terms, nfac, fam = ints[0], ints[1], ints[2:2 + mt], ints[2 + mt:]
    coef, scale, alpha = reals[tkm.DESC_COEF:], reals[tkm.DESC_S:], reals[tkm.DESC_A:]

    def leaf(f, s, a):
        if f == 0:
            return torch.exp(s * d2)
        if f == 4:
            return torch.exp(a * torch.log(1.0 + s * d2))
        r = torch.sqrt(s * d2)
        poly = {1: 1.0, 2: 1.0 + r, 3: 1.0 + r * (1.0 + r / 3.0)}[f]
        return poly * torch.exp(-r)

    if kind != cov_assembly.COMPOSITE:
        return coef[0] * leaf(kind, scale[0], alpha[0])
    out = torch.zeros_like(d2)
    for t in range(n_terms):
        prod = torch.full_like(d2, float(coef[t]))
        for q in range(nfac[t]):
            i = t * mf + q
            prod = prod * leaf(fam[i], scale[i], alpha[i])
        out = out + prod
    return out


@pytest.mark.parametrize("name", ZOO)
def test_kernel_descriptor_evaluates_to_kfree(name):
    """The descriptor of every cell, evaluated as the kernel does, equals the plain kfree (float64).

    Isotropic cells take the expanded-form d2; ARD the difference form sum (a - b)^2 / l.
    """
    rng = np.random.default_rng(11)
    _, kern_t, _, pt = _params(name, rng)
    xa = torch.from_numpy(rng.standard_normal((17, 2)))
    xb = torch.from_numpy(rng.standard_normal((13, 2)))
    (launch,) = tkm.descriptor_table(kern_t, pt, 2, torch.float64, "cpu").launches
    ints, reals, ard = launch.ints, launch.table[0], launch.ard
    assert len(ints) == 2 + cov_assembly.MAX_TERMS * (1 + cov_assembly.MAX_FACTORS)
    assert reals.shape == (cov_assembly.TABLE_WIDTH,)
    if not ard:
        d2 = tkm.sq_dists(xa, xb)
    else:
        inv_l = reals[tkm.DESC_INV_L:tkm.DESC_INV_L + 2]
        d2 = (((xa[:, None, :] - xb[None, :, :]) ** 2) * inv_l).sum(-1)
    got = _kernel_rendition(ints, reals, d2)
    want = kern_t.kfree(tkm.tree_map(lambda p: torch.as_tensor(p, dtype=torch.float64), pt), xa, xb)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    # one scaled leaf takes its own epilogue (White drops out of the sum); a product, or nothing, the loop
    assert (ints[0] == cov_assembly.COMPOSITE) == (name in ("prod_se_m32", "white"))


def test_descriptor_limits_raise_value_error():
    def table(k, d=2):
        return tkm.descriptor_table(k, k.default_params(), d, torch.float32, "cpu")

    with pytest.raises(ValueError, match="at most"):
        table(tkm.Sum(*[tkm.Matern52()] * (cov_assembly.MAX_TERMS + 1)))
    with pytest.raises(ValueError, match="at most"):
        table(tkm.Product(*[tkm.Matern32()] * (cov_assembly.MAX_FACTORS + 1)))
    with pytest.raises(ValueError, match="features"):
        table(tkm.ARDSquaredExponential(ndim=cov_assembly.MAX_ARD_D + 1), cov_assembly.MAX_ARD_D + 1)


def test_normal_form_distributes_products_and_drops_white():
    k = tkm.Product(tkm.Sum(tkm.SquaredExponential(), tkm.White()), tkm.Scaled(tkm.Sum(tkm.Matern12(), tkm.RationalQuadratic())))
    p = ((tkm.SEKernelParams(1.5, 2.0, 0.1), tkm.WhiteKernelParams(0.3)),
         tkm.ScaledParams(3.0, (tkm.SEKernelParams(0.5, 0.25, 0.1), tkm.RQKernelParams(2.0, 4.0, 0.1, 0.5))))
    terms = tkm.normal_form(k, p)
    assert [c for c, _ in terms] == [2.0 * 3.0 * 0.25, 2.0 * 3.0 * 4.0]
    assert [[f.family for f in fs] for _, fs in terms] == [["se", "matern12"], ["se", "rq"]]
    assert tkm.normal_form(tkm.White(), tkm.WhiteKernelParams()) == []


def test_ard_distance_on_offset_data():
    """The Pallas body's difference form against the plain expanded form, far from the origin.

    Offsetting the features by 30 leaves the kernel unchanged, but the plain
    version's d2 then cancels: its distance from the difference form (which
    is what the Pallas body, and the CUDA kernel, compute) stays inside the
    kernel's stated tolerance, and well above the tolerance on centred data.
    """
    rng = np.random.default_rng(21)
    kern_j, kern_t = _pair("se_ard2")
    ls = np.asarray([0.7, 1.6], np.float32)
    pj, pt = jkm.ARDKernelParams(jnp.asarray(ls)), tkm.ARDKernelParams(torch.from_numpy(ls))
    x = rng.standard_normal((1, 32, 2)).astype(np.float32) / 2
    gaps = {}
    for off in (0.0, 30.0):
        xo = x + np.float32(off)
        pallas = np.asarray(jcov.cov_tiles(jnp.asarray(xo), jnp.asarray(xo), jnp.zeros(1, jnp.int32),
                                           jnp.zeros(1, jnp.int32), kernel=kern_j, params=pj, n_valid_r=32,
                                           n_valid_c=32, symmetric=False, interpret=True))
        xt = torch.from_numpy(xo)
        plain = cov_assembly.cov_tiles_plain(xt, xt, 0, 0, 32, 32, pt, symmetric=False, kernel=kern_t).numpy()
        gaps[off] = (float(np.abs(pallas - plain).max()), cov_assembly.cov_tiles_tolerance(kern_t, pt, xt[0], xt[0]))
    assert gaps[0.0][0] <= gaps[0.0][1] < 1e-4
    assert gaps[30.0][0] <= gaps[30.0][1] and gaps[30.0][0] > 1e-4


# ---------------------------------------------------------------------------
# ops.cov_tiles' card route with a composite's params tree
# ---------------------------------------------------------------------------


def test_cov_tiles_card_route_gives_every_tensor_leaf_its_gradient(monkeypatch):
    """Tensor leaves at every depth of Sum(Scaled(Matern52), White) are operands of the gradient helper."""
    seen = []
    launcher = ops._cov.cov_tiles_cuda

    def kernel(xa, xb, *args, kernel=None, **kw):  # counts its call as the CUDA wrapper counts its launch
        seen.append(torch.is_grad_enabled())
        launcher.launches += 1
        p = tkm.tree_map(lambda l: l.detach() if isinstance(l, torch.Tensor) else l, args[-1])
        with torch.no_grad():
            return cov_assembly.cov_tiles_plain(xa.detach(), xb.detach(), *args[:-1], p, kernel=kernel, **kw)

    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(ops._cov, "cov_tiles_cuda", kernel)
    ops.reset_launch_counts()
    kern = tkm.Sum(tkm.Scaled(tkm.Matern52()), tkm.White())
    vals = [1.7, 0.9, 1.2, 0.05, 0.2]  # scale, l, v, noise of M52, white noise
    live = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in vals]
    params = (tkm.ScaledParams(live[0], tkm.SEKernelParams(live[1], live[2], live[3])), tkm.WhiteKernelParams(live[4]))
    rng = np.random.default_rng(3)
    xa = torch.from_numpy(rng.standard_normal((2, 6, 2)))
    row0 = torch.tensor([0, 6])
    out = ops.cov_tiles(xa, xa, row0, row0, 10, 10, params, symmetric=True, kernel=kern)
    assert seen == [False] and ops.launch_counts()["cov_tiles"] == 1 and out.grad_fn is not None
    want = cov_assembly.cov_tiles_plain(xa, xa, row0, row0, 10, 10, params, symmetric=True, kernel=kern)
    cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)))
    got_g = torch.autograd.grad(out, live, cot)
    want_g = torch.autograd.grad(want, live, cot)
    assert all(float(g.abs()) > 0 for g in got_g)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Through the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["matern52", "sum_m52_white", "se_ard2"])
def test_gp_predict_with_uncertainty_matches_the_reference(name):
    """A cold fused prediction (n = 64, tile 32) per kernel against the JAX package's."""
    rng = np.random.default_rng(7)
    kern_j, kern_t, pj, pt = _params(name, rng)
    x = rng.standard_normal((64, 2)).astype(np.float32)
    y = (np.sin(x.sum(-1)) + 0.1 * rng.standard_normal(64)).astype(np.float32)
    xt = rng.standard_normal((11, 2)).astype(np.float32)
    mean_j, cov_j = jpred.predict(x, y, xt, pj, 32, full_cov=True, kernel=kern_j)
    gp = GaussianProcess(x, y, params=pt, tile_size=32, kernel=kern_t, device="cpu")
    mean, var = gp.predict_with_uncertainty(xt)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=0, atol=5e-4)
    np.testing.assert_allclose(var.numpy(), np.diagonal(np.asarray(cov_j)), rtol=0, atol=5e-4)
    assert gp._cache_warm()


def test_kernel_params_from_numpy_keeps_the_tree():
    kern_j, kern_t, pj, pt = _params("sum_m52_white", np.random.default_rng(1))
    assert isinstance(pt, tuple) and isinstance(pt[0], tkm.ScaledParams) and isinstance(pt[1], tkm.WhiteKernelParams)
    assert float(kern_t.noise(pt)) == pytest.approx(float(kern_j.noise(pj)), rel=1e-6)
    with pytest.raises(ValueError, match="leaves"):
        convert.kernel_params_from_numpy(kern_t, [1.0])
    assert math.isclose(float(tkm.get_kernel("rq").diag(tkm.RQKernelParams(vertical=2.5))), 2.5)


# ---------------------------------------------------------------------------
# Per-problem hyperparameters: (B,) leaves in one stack of B * G tiles
# ---------------------------------------------------------------------------


def _fleet_params(name, b=3):
    """A zoo cell's (B,)-leaved params tree (seeded leaves for each problem) and the B single trees
    (floats and tensors, as ``convert`` makes them from one problem's leaves)."""
    import jax

    kern_j, kern_t = _pair(name)
    rng = np.random.default_rng(40 + ZOO.index(name))
    per = [_leaves(name, kern_j, rng) for _ in range(b)]
    if name == "se_ard2":
        per = [[np.asarray([0.7 + 0.3 * i, 1.6 - 0.2 * i], np.float32)] + p[1:] for i, p in enumerate(per)]
    singles = [convert.kernel_params_from_numpy(kern_t, p) for p in per]
    stacked = convert.kernel_params_from_numpy(kern_t, [np.stack(ls) for ls in zip(*per)])
    return kern_j, kern_t, per, singles, stacked


@pytest.mark.parametrize("name", ZOO)
def test_cov_tiles_plain_with_per_problem_leaves_matches_a_loop(name):
    """One call over 3 problems' tiles with (3,) leaves equals a loop of single-problem calls, bitwise,
    and the reference's own route for (B,) leaves (its executor's problem-batched jnp tile), to 1e-5."""
    import jax

    from repro.core import executor as jex

    kern_j, kern_t, per, singles, stacked = _fleet_params(name)
    b, g = len(singles), 2
    rng = np.random.default_rng(7)
    xa = torch.from_numpy(rng.standard_normal((b * g, 16, 2)).astype(np.float32) / 1.5)
    xb = torch.from_numpy(rng.standard_normal((b * g, 12, 2)).astype(np.float32) / 1.5)
    row0, col0 = torch.tensor([0, 16] * b), torch.tensor([0, 0] * b)
    nvp = np.asarray([30, 20, 9], np.int32)  # three ragged problems' frontiers
    nv = torch.from_numpy(nvp).repeat_interleave(g)
    treedef = jax.tree_util.tree_structure(kern_j.default_params())
    pj = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(np.stack(ls)) for ls in zip(*per)])
    for sym in (True, False):
        xbs = xa if sym else xb
        c0 = row0 if sym else col0
        got = cov_assembly.cov_tiles_plain(xa, xbs, row0, c0, nv, nv, stacked, symmetric=sym, kernel=kern_t)
        for i in range(b):
            s = slice(i * g, (i + 1) * g)
            # the problem's own leaves, as the 0-d tensors of the stack (the same arithmetic as (B,) leaves)
            one = cov_assembly.cov_tiles_plain(xa[s], xbs[s], row0[s], c0[s], nv[s], nv[s],
                                               tkm.gather_params(stacked, i, kern_t), symmetric=sym, kernel=kern_t)
            torch.testing.assert_close(got[s], one, rtol=0, atol=0)
        fn = jex._cov_batch_fn_batched("jnp", pj, jnp.asarray(nvp), jnp.asarray(nvp), sym, kern_j)
        want = fn(jnp.asarray(xa.numpy().reshape(b, g, 16, 2)), jnp.asarray(xbs.numpy().reshape(b, g, -1, 2)),
                  jnp.asarray(row0.numpy()[:g]), jnp.asarray(c0.numpy()[:g]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ZOO)
def test_descriptor_table_has_one_row_per_problem(name):
    """The kernel's table for (3,) leaves holds, row by row, each problem's own single-problem row
    (float64; P = 1 for shared leaves), and every row evaluates to that problem's kfree."""
    _, kern_t, _, singles, stacked = _fleet_params(name)
    desc = tkm.descriptor_table(kern_t, stacked, 2, torch.float64, "cpu")
    assert desc.problems == 3 and all(l.table.shape == (3, cov_assembly.TABLE_WIDTH) for l in desc.launches)
    rng = np.random.default_rng(8)
    xa, xb = (torch.from_numpy(rng.standard_normal((n, 2))) for n in (9, 7))
    for i, single in enumerate(singles):
        one = tkm.descriptor_table(kern_t, single, 2, torch.float64, "cpu")
        assert one.problems == 1 and one.terms == desc.terms
        for a, b in zip(desc.launches, one.launches):
            assert a.ints == b.ints and a.ard == b.ard
            torch.testing.assert_close(a.table[i], b.table[0], rtol=0, atol=0)
        assert torch.equal(desc.select(i).launches[0].table, one.launches[0].table)
        if not desc.mixed:
            launch = desc.launches[0]
            if launch.ard:
                d2 = (((xa[:, None] - xb[None]) ** 2) * launch.table[i, tkm.DESC_INV_L:tkm.DESC_INV_L + 2]).sum(-1)
            else:
                d2 = tkm.sq_dists(xa, xb)
            got = _kernel_rendition(list(launch.ints), launch.table[i], d2)
            want = kern_t.kfree(tkm.tree_map(lambda p: torch.as_tensor(p, dtype=torch.float64), single), xa, xb)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    shared = tkm.descriptor_table(kern_t, singles[0], 2, torch.float32, "cpu")
    assert shared.problems == 1 and shared.launches[0].table.dtype == torch.float32


@pytest.mark.parametrize("name", ["se", "matern32", "se_ard2"])
def test_dense_assembly_with_padding_matches_reference(name, rng):
    """The dense ``assemble_*`` with the reference's padding counts, noise switch and dtype:
    padded rows and columns are identity (training) or zero (cross, prior), as the reference's."""
    kern_j, kern_t, pj, pt = _params(name, rng)
    x = rng.standard_normal((11, 2)).astype(np.float32)
    xt = rng.standard_normal((7, 2)).astype(np.float32)
    xj, xtj, xc, xtc = jnp.asarray(x), jnp.asarray(xt), torch.from_numpy(x), torch.from_numpy(xt)
    for nv in (None, 11, 8):
        np.testing.assert_allclose(tkm.assemble_covariance(xc, pt, kernel=kern_t, n_valid=nv).numpy(),
                                   np.asarray(jkm.assemble_covariance(xj, pj, kernel=kern_j, n_valid=nv)), rtol=0, atol=1e-5)
    for ntv, nv in ((None, None), (5, None), (None, 9), (4, 6)):
        np.testing.assert_allclose(tkm.assemble_cross_covariance(xtc, xc, pt, kernel=kern_t, n_test_valid=ntv, n_train_valid=nv).numpy(),
            np.asarray(jkm.assemble_cross_covariance(xtj, xj, pj, kernel=kern_j, n_test_valid=ntv, n_train_valid=nv)),
            rtol=0, atol=1e-5)
    for nv in (None, 5):
        for noise in (False, True):
            np.testing.assert_allclose(tkm.assemble_prior_covariance(xtc, pt, kernel=kern_t, n_valid=nv, include_noise=noise).numpy(),
                np.asarray(jkm.assemble_prior_covariance(xtj, pj, kernel=kern_j, n_valid=nv, include_noise=noise)),
                rtol=0, atol=1e-5)
    k64 = tkm.assemble_covariance(xc, pt, kernel=kern_t, dtype=torch.float64)
    assert k64.dtype == torch.float64 and tkm.assemble_covariance(xc.double(), pt, kernel=kern_t).dtype == torch.float32


@pytest.mark.parametrize("diag_offset", [None, 0, 5, -3])
def test_se_kernel_matches_reference(diag_offset):
    """The dense SE block, with the noise on the global diagonal at ``diag_offset``, against the reference's."""
    rng = np.random.default_rng(7)
    x1 = rng.standard_normal((12, 3)).astype(np.float32)
    x2 = rng.standard_normal((9, 3)).astype(np.float32)
    jp, tp = jkm.SEKernelParams(0.8, 1.3, 0.2), tkm.SEKernelParams(0.8, 1.3, 0.2)
    want = np.asarray(jkm.se_kernel(jnp.asarray(x1), jnp.asarray(x2), jp, diag_offset=diag_offset))
    got = tkm.se_kernel(torch.from_numpy(x1), torch.from_numpy(x2), tp, diag_offset=diag_offset)
    assert got.dtype == torch.float32 and got.shape == (12, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if diag_offset is not None:  # the noise lands on i + offset == j only
        plain = tkm.se_kernel(torch.from_numpy(x1), torch.from_numpy(x2), tp).numpy()
        i, j = np.nonzero(np.abs(got.numpy() - plain) > 1e-7)
        assert (i + diag_offset == j).all() and len(i) == sum(0 <= r + diag_offset < 9 for r in range(12))
