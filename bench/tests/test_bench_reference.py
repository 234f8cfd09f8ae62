"""The plain reference against closed forms."""

import math

import torch

from bench.reference import gp

P = {"lengthscale": 0.7, "vertical": 1.3, "noise": 0.2}


def test_one_training_point_closed_form():
    x = torch.tensor([[0.3, -0.1]], dtype=torch.float64)
    y = torch.tensor([0.9], dtype=torch.float64)
    xt = torch.tensor([[0.0, 0.4], [0.3, -0.1]], dtype=torch.float64)
    k = P["vertical"] * torch.exp(-((xt - x) ** 2).sum(1) / (2 * P["lengthscale"]))
    mean, var = gp.exact_posterior(x, y, xt, P, with_var=True)
    s = P["vertical"] + P["noise"]
    assert torch.allclose(mean, k * 0.9 / s, rtol=1e-13, atol=0)
    assert torch.allclose(var, P["vertical"] - k * k / s, rtol=1e-13, atol=0)


def test_dtc_on_every_training_point_is_the_exact_gp():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 3, generator=g, dtype=torch.float64)
    y = torch.randn(64, generator=g, dtype=torch.float64)
    xt = torch.randn(20, 3, generator=g, dtype=torch.float64)
    exact = gp.exact_posterior(x, y, xt, P, with_var=False)[0]
    assert torch.allclose(gp.subset_inducing(x, 64), x)
    dtc = gp.dtc_mean(x, y, xt, P, 64, 1e-10)
    assert float((dtc - exact).abs().max()) < 1e-6 * float(exact.abs().max())


def test_nlml_and_gradient_against_autograd():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(40, 2, generator=g, dtype=torch.float64)
    y = torch.randn(40, generator=g, dtype=torch.float64)
    theta = torch.tensor([0.8, 1.1, 0.3], dtype=torch.float64, requires_grad=True)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    k = theta[1] * torch.exp(-d2 / (2 * theta[0])) + theta[2] * torch.eye(40, dtype=torch.float64)
    want = 0.5 * y @ torch.linalg.solve(k, y) + 0.5 * torch.logdet(k) + 20 * math.log(2 * math.pi)
    want.backward()
    val, grad = gp.nlml_and_grad(x, y, theta.detach())
    assert abs(float(val) - float(want)) < 1e-10 * abs(float(want))
    assert torch.allclose(grad, theta.grad, rtol=1e-9, atol=1e-12)


def test_adam_first_step_moves_each_raw_leaf_by_lr():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(30, 2, generator=g, dtype=torch.float64)
    y = torch.randn(30, generator=g, dtype=torch.float64)
    theta0 = torch.tensor([1.0, 1.0, 0.1], dtype=torch.float64)
    losses, theta, g0 = gp.adam(x, y, theta0, 1, 0.05)
    raw0, raw1 = torch.log(torch.expm1(theta0)), torch.log(torch.expm1(theta))
    assert torch.allclose(raw1 - raw0, -0.05 * torch.sign(g0), rtol=1e-6)
    assert float(losses[0]) == float(gp.nlml_and_grad(x, y, theta0)[0])


def test_blocked_cholesky_is_the_library_factor():
    g = torch.Generator().manual_seed(6)
    a = torch.randn(gp.PANEL + 300, gp.PANEL + 300, generator=g, dtype=torch.float64)
    a = a @ a.T + a.shape[0] * torch.eye(a.shape[0], dtype=torch.float64)
    got = gp.cholesky(a.clone())
    assert float((got - torch.linalg.cholesky(a)).abs().max()) < 1e-12 * float(a.abs().max()) ** 0.5


def test_dense_pipeline_is_the_reference_mean():
    from bench import dense

    g = torch.Generator().manual_seed(7)
    x = torch.randn(50, 3, generator=g, dtype=torch.float64)
    y = torch.randn(50, generator=g, dtype=torch.float64)
    xt = torch.randn(9, 3, generator=g, dtype=torch.float64)
    want = gp.exact_posterior(x, y, xt, P, with_var=False)[0]
    assert torch.allclose(dense.predict(x, y, xt, P), want, rtol=1e-10, atol=1e-12)
