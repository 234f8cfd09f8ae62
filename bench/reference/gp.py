"""Plain GP regression in PyTorch: the benchmark's own reference.

Dense textbook formulas (Rasmussen and Williams, ch. 2 and 5; the DTC
mean in the whitened form of Titsias' SGPR), computed in the dtype the
caller names: float64 for the reference, float32 with TF32 products for the
control.  Every O(n^3) product is a matrix product, so that the control's
TF32 reaches it: the n x n Cholesky factor is the blocked right-looking
algorithm with its trailing updates as products, and K^-1 is L^-T L^-1 as a
product.  The DTC's O(n m^2) work is the product W W^T; its two m x m
factors are the library's.
n-sized products go in blocks of rows so that the float64 reference fits
beside what the run still holds.  Imports nothing of the program.

The SE kernel is the paper's, k(a, b) = v exp(-|a - b|^2 / (2 l)) with l
unsquared, and the training covariance's diagonal is v + sigma^2 exactly.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BLOCK = 8192
PANEL = 1024


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor by blocked right-looking elimination, in place on ``a``: each panel's
    diagonal block by ``torch.linalg.cholesky``, the panel below it by a triangular solve, and the
    trailing update as a matrix product."""
    n = a.shape[0]
    for k in range(0, n, PANEL):
        e = min(k + PANEL, n)
        a[k:e, k:e] = torch.linalg.cholesky(a[k:e, k:e])
        if e < n:
            a[e:, k:e] = torch.linalg.solve_triangular(a[k:e, k:e].mT, a[e:, k:e], upper=True, left=False)
            a[e:, e:].addmm_(a[e:, k:e], a[e:, k:e].T, alpha=-1.0)
    return a.tril_()


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a_i - b_j|^2 by the expanded form, clamped at zero (one matmul)."""
    d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)
    return d2.clamp_(min=0.0)


def se(a: torch.Tensor, b: torch.Tensor, p: Dict) -> torch.Tensor:
    return p["vertical"] * torch.exp(sq_dists(a, b) * (-0.5 / p["lengthscale"]))


def train_cov(x: torch.Tensor, p: Dict, diag: float) -> torch.Tensor:
    """k(x, x) with its diagonal set to ``diag`` exactly."""
    k = torch.empty((x.shape[0], x.shape[0]), dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], BLOCK):
        k[s:s + BLOCK] = se(x[s:s + BLOCK], x, p)
    k.diagonal().fill_(diag)
    return k


def exact_posterior(x, y, xt, p: Dict, with_var: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean (and the variance without noise, else None) of the exact GP at xt."""
    chol = cholesky(train_cov(x, p, p["vertical"] + p["noise"]))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    means, variances = [], []
    for s in range(0, xt.shape[0], BLOCK):
        ks = se(xt[s:s + BLOCK], x, p)
        means.append(ks @ alpha)
        if with_var:
            v = torch.linalg.solve_triangular(chol, ks.T, upper=False)
            variances.append(p["vertical"] - (v * v).sum(0))
    return torch.cat(means), (torch.cat(variances) if with_var else None)


def subset_inducing(x: torch.Tensor, m: int) -> torch.Tensor:
    """Every (n / m)-th training row: the strided subset of regressors."""
    n = x.shape[0]
    idx = torch.arange(m, device=x.device) * n // min(m, n)
    return x[idx.clamp(max=n - 1)]


def dtc_mean(x, y, xt, p: Dict, m: int, jitter: float) -> torch.Tensor:
    """DTC mean s^-2 K_*u A^-1 K_un y, A = K_uu + s^-2 K_un K_nu, through the
    whitened system B = I + s^-2 W W^T, W = L_uu^-1 K_un."""
    u = subset_inducing(x, m)
    l_uu = torch.linalg.cholesky(train_cov(u, p, p["vertical"] + jitter))
    inv_s2 = 1.0 / p["noise"]
    b = torch.zeros((m, m), dtype=x.dtype, device=x.device)
    c_w = torch.zeros((m,), dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], BLOCK):
        w = torch.linalg.solve_triangular(l_uu, se(u, x[s:s + BLOCK], p), upper=False)
        b += w @ w.T
        c_w += w @ y[s:s + BLOCK]
    b = b * inv_s2
    b.diagonal().add_(1.0)
    l_b = torch.linalg.cholesky(b)
    z = torch.cholesky_solve(c_w[:, None], l_b)
    gamma = torch.linalg.solve_triangular(l_uu.T, z, upper=True)[:, 0]
    return torch.cat([inv_s2 * (se(xt[s:s + BLOCK], u, p) @ gamma) for s in range(0, xt.shape[0], BLOCK)])


LOG_2PI = math.log(2.0 * math.pi)
NAMES = ("lengthscale", "vertical", "noise")


def nlml_and_grad(x, y, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NLML and its gradient in (l, v, sigma^2) (R&W eq. 5.9: 0.5 tr((K^-1 - a a^T) dK))."""
    p = dict(zip(NAMES, theta.tolist()))
    n = x.shape[0]
    d2 = torch.empty((n, n), dtype=x.dtype, device=x.device)
    for s in range(0, n, BLOCK):
        d2[s:s + BLOCK] = sq_dists(x[s:s + BLOCK], x)
    d2.diagonal().zero_()
    kf = torch.exp(d2 * (-0.5 / p["lengthscale"])).mul_(p["vertical"])
    k = kf.clone()
    k.diagonal().add_(p["noise"])
    chol = cholesky(k)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    nlml = 0.5 * (y @ alpha) + torch.log(chol.diagonal()).sum() + 0.5 * n * LOG_2PI
    l_inv = torch.linalg.solve_triangular(chol, torch.eye(n, dtype=x.dtype, device=x.device), upper=False)
    del chol, k
    s_mat = l_inv.T @ l_inv
    del l_inv
    s_mat.addr_(alpha, alpha, alpha=-1.0).mul_(0.5)
    g_noise = s_mat.diagonal().sum()
    s_mat.mul_(kf)
    g_vertical = s_mat.sum() / p["vertical"]
    g_length = (s_mat * d2).sum() / (2.0 * p["lengthscale"] ** 2)
    return nlml, torch.stack((g_length, g_vertical, g_noise))


def adam(x, y, theta0: torch.Tensor, steps: int, lr: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on r = softplus^-1(theta).

    Returns the losses before each update, the final theta and the first gradient in theta.
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    raw = torch.log(torch.expm1(theta0))
    m = torch.zeros_like(raw)
    v = torch.zeros_like(raw)
    losses, grads = [], []
    for t in range(1, steps + 1):
        theta = torch.nn.functional.softplus(raw)
        loss, g_theta = nlml_and_grad(x, y, theta)
        losses.append(loss)
        grads.append(g_theta)
        g = g_theta * torch.sigmoid(raw)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        raw = raw - lr * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)
    return torch.stack(losses), torch.nn.functional.softplus(raw), grads[0]
