"""GP hyperparameter training through the negative log marginal likelihood, in PyTorch.

    nlml = 0.5 * ( y^T alpha + log det K + n log 2 pi )

The counterpart of ``repro/core/mll.py``.  Evaluation paths:

* :func:`negative_log_marginal_likelihood` — the dense reference (one
  ``torch.linalg.cholesky``, differentiated by autograd);
* :func:`nlml_from_state` — the value at fixed hyperparameters from a cached
  tiled :class:`repro_torch.core.predict.PosteriorState` (quadratic term from
  the alpha chunks, log-determinant from the packed factor's diagonal
  tiles), with no refactorization;
* :func:`nlml_tiled` — the trainable tiled NLML: the fused program with
  zero test tiles (assembly, tiled Cholesky, both substitutions; on the card
  cov_tiles, POTRF, TRSM and TRAIL) plus the two heads.  ``vjp="custom"``
  (default) is the blocked reverse mode of :class:`_NLMLTiled`: K^{-1} from
  the tiled factor, then a dense O(n^2) contraction with the kernel's
  hand-derived ``kfree_vjp``.
  ``vjp="autodiff"`` differentiates through the program, whose tile ops
  carry the reference's gradients (:mod:`repro_torch.kernels.ops`);
  families without a hand-derived VJP take it;
* :func:`nlml_lowrank` — the O(n m^2) Nystrom NLML of
  :mod:`repro_torch.core.lowrank`, with its blocked reverse mode
  (:class:`_NLMLLowRank`);
* :func:`nlml_tiled_batched` / :func:`nlml_lowrank_batched` — the (B,)
  vector of B stacked problems' NLMLs from one problem-batched program,
  with per-problem hyperparameter leaves; the tiled one's blocked reverse
  mode takes the B inverses K^{-1} in one batched ``cholesky_inverse``.

:func:`optimize_hyperparameters` runs Adam on any of them in unconstrained
softplus space, one Python step per optimizer step (the reference scans the
same update in one compiled program);
:func:`optimize_hyperparameters_batched` trains B problems side by side,
with independent Adam moments per problem (:func:`adam_batched`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import cholesky as chol
from repro_torch.core import kernels_math as km
from repro_torch.core import lowrank
from repro_torch.core import predict as pred
from repro_torch.core import tiling, triangular
from repro_torch.device import resolve_device

LOG_2PI = math.log(2.0 * math.pi)


def _inputs(x, y, dtype, dev):
    """x (n, D) and y (n,) as ``dtype`` tensors on ``dev`` (autograd kept); x (n,) becomes (n, 1)."""
    x = torch.as_tensor(x, device=dev).to(dtype)
    if x.ndim == 1:
        x = x[:, None]
    return x, torch.as_tensor(y, device=dev).to(dtype).reshape(-1)


def negative_log_marginal_likelihood(
    x, y, params, *, dtype=torch.float32, kernel=None, device="cuda"
) -> torch.Tensor:
    """Exact NLML through the dense Cholesky (differentiable)."""
    x, y = _inputs(x, y, dtype, resolve_device(device))
    n = y.shape[0]
    k = km.assemble_covariance(x, params, kernel=kernel, dtype=None)
    l = chol.monolithic_cholesky(k)
    beta = torch.linalg.solve_triangular(l, y[:, None], upper=False)
    quad = torch.sum(beta * beta)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(l)))
    return 0.5 * (quad + logdet + n * LOG_2PI)


def nlml_from_state(state, y, *, dtype=None, n_valid=None) -> torch.Tensor:
    """NLML from a cached tiled posterior, with no refactorization.

    quad = y^T alpha (padded rows contribute 0, as y pads with 0); logdet =
    2 sum log diag(L) from the packed factor's diagonal tiles (padded rows
    contribute log 1 = 0, or are masked past ``n_valid``).  A stacked state
    with y (B, n) gives the (B,) vector; a ragged one's frontiers
    (``n_valid`` or ``state.n_valid``, (B,)) replace n in the constant term
    and mask the factor's diagonal.
    """
    dtype = state.alpha.dtype if dtype is None else dtype
    batched = state.alpha.ndim == 3
    y = torch.as_tensor(y, device=state.device).to(dtype)
    y = y.reshape(y.shape[0], -1) if batched else y.reshape(-1)
    yc = tiling.pad_vector(y, state.m)
    quad = triangular.problem_sums(yc * state.alpha)
    nv = getattr(state, "n_valid", None) if n_valid is None else n_valid
    n = y.shape[-1] if nv is None else torch.as_tensor(nv, device=state.device).to(dtype)
    logdet = triangular.logdet_from_factor(state.lpacked, state.alpha.shape[-2], n_valid=nv)
    return 0.5 * (quad + logdet + n * LOG_2PI)


# ---------------------------------------------------------------------------
# The trainable tiled NLML.
#
# Forward: the fused program with zero test tiles (predict.nlml_program_env);
# heads quad = sum(yc * alpha) and logdet from the factor's diagonal tiles.
#
# Backward (vjp="custom"): the closed form dNLML/dK = 0.5 (K^{-1} - alpha
# alpha^T) =: S.  The O(n^3) piece is K^{-1} = L^{-T} L^{-1}, from the tiled
# factor unpacked, by torch.cholesky_inverse.  The reference takes it by one
# tiled matrix solve on identity tiles and a tiled gram; in float32 that
# route's rounding is coherent enough to move the vertical scale's component
# by ~1e-3 of its size at n = 16384 (on an H100: 9.5e-4, against 2.9e-6 for
# cholesky_inverse, which also took 0.21 s against 0.35).  The O(n^2)
# contraction of S with dK/dtheta is the kernel's kfree_vjp, and
# dK/dsigma^2 = I adds tr(S) to the noise leaf; dNLML/dy = alpha.  The
# padded block of K is a constant identity, so everything is taken on the
# unpadded n x n region.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Config:
    tile_size: int
    n_streams: Optional[int]
    update_dtype: Optional[torch.dtype]
    dtype: torch.dtype
    kernel: km.Kernel
    device: torch.device
    batch_dispatch: str = "flat"


def _nlml_forward(cfg: _Config, x, y, params):
    """The tiled NLML program: (value, (packed factor, alpha chunks)); stacked inputs give (B,) values."""
    n = y.shape[-1]
    env, yc = pred.nlml_program_env(
        x, y, params, cfg.tile_size, n_streams=cfg.n_streams, update_dtype=cfg.update_dtype,
        dtype=cfg.dtype, batch_dispatch=cfg.batch_dispatch, kernel=cfg.kernel, device=cfg.device,
    )
    quad = triangular.problem_sums(yc * env["alpha"])
    logdet = triangular.logdet_from_factor(env["packed"], env["alpha"].shape[-2])
    return 0.5 * (quad + logdet + n * LOG_2PI), (env["packed"], env["alpha"])


def _nlml_dense_grads(kernel, params, xd, alpha, kinv):
    """O(n^2) contraction of S = 0.5 (K^{-1} - alpha alpha^T) with dK/dtheta.

    xd (n, D), alpha (n,), kinv (n, n) (overwritten: S is formed in its
    place), scalar params leaves.  Returns (g_x, g_y, g_params).
    """
    s = kinv.mul_(0.5).addr_(alpha, alpha, alpha=-0.5)
    g_params, g_xa, g_xb = kernel.kfree_vjp(params, xd, xd, s)
    g_params = dataclasses.replace(g_params, noise=g_params.noise + torch.trace(s))
    return g_xa + g_xb, alpha, g_params


def _cast(params, dtype, dev):
    return km.tree_map(lambda p: torch.as_tensor(p, dtype=dtype, device=dev), params)


class _NLMLTiled(torch.autograd.Function):
    """Forward: the tiled NLML program; backward: the blocked reverse mode (analytic kernels)."""

    @staticmethod
    def forward(ctx, cfg, split, x, y, *values):
        val, ctx.factor = _nlml_forward(cfg, x, y, split.rebuild(values))
        ctx.cfg, ctx.split = cfg, split
        ctx.save_for_backward(x, y, *values)
        return val

    @staticmethod
    def backward(ctx, ct):
        cfg, split = ctx.cfg, ctx.split
        x, y, *values = ctx.saved_tensors
        lpacked, alpha_c = ctx.factor
        n = y.shape[0]
        # O(n^3): K^{-1} from the factor
        kinv = torch.cholesky_inverse(tiling.unpack_lower(lpacked)[:n, :n])
        alpha = alpha_c.reshape(-1)[:n]
        params_d = _cast(split.rebuild(values), cfg.dtype, cfg.device)
        g_x, g_y, g_params = _nlml_dense_grads(cfg.kernel, params_d, x.to(cfg.dtype), alpha, kinv)
        needs = ctx.needs_input_grad
        grads = [(ct * g).to(v) if need else None for g, v, need in zip(split.pick(g_params), values, needs[4:])]
        return (None, None, (ct * g_x).to(x) if needs[2] else None, (ct * g_y).to(y) if needs[3] else None,
                *grads)


def nlml_tiled(
    x,
    y,
    params,
    *,
    tile_size: int = 256,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=torch.float32,
    vjp: str = "custom",
    kernel=None,
    device="cuda",
) -> torch.Tensor:
    """NLML through the tiled fused program, differentiable in (x, y, params).

    Value-equivalent to :func:`negative_log_marginal_likelihood` for any n
    (identity padding).  ``vjp="custom"`` (default) takes the blocked
    reverse mode; ``vjp="autodiff"`` differentiates through the program's
    launches.  Only kernels with ``analytic_vjp`` (SE, Matérn 5/2) take the
    blocked rule; any other family takes ``vjp="autodiff"``.
    """
    dev = resolve_device(device)
    x, y = _inputs(x, y, dtype, dev)
    kernel = km.resolve_kernel(kernel)
    cfg = _Config(int(tile_size), n_streams, update_dtype, dtype, kernel, dev)
    if vjp == "custom" and not kernel.analytic_vjp:
        vjp = "autodiff"
    if vjp == "custom":
        split = km.TensorLeaves(params)
        return _NLMLTiled.apply(cfg, split, x, y, *split.values())
    if vjp == "autodiff":
        return _nlml_forward(cfg, x, y, params)[0]
    raise ValueError(f"vjp must be 'custom' or 'autodiff', got {vjp!r}")


# -- B problems at once --------------------------------------------------------
#
# The forward is the problem-batched NLML program ((B,) values).  The
# backward keeps the port's K^{-1}: ONE batched cholesky_inverse of the B
# unpacked factors (the reference's tiled solve on identity tiles lost the
# vertical component in float32, see above), then the O(n^2) contraction
# per problem with the kernel's kfree_vjp.  Leaves are (B,) throughout
# (nlml_tiled_batched broadcasts shared ones first).


def _stack_trees(trees):
    """One tree whose leaves stack the trees' leaves along a new leading axis."""
    leaves = [km.tree_leaves(t) for t in trees]
    return km.tree_unflatten(km.tree_flatten(trees[0])[1], [torch.stack(ls) for ls in zip(*leaves)])


class _NLMLTiledBatched(torch.autograd.Function):
    """Forward: the batched NLML program (B,); backward: the blocked reverse mode per problem."""

    @staticmethod
    def forward(ctx, cfg, split, x, y, *values):
        val, ctx.factor = _nlml_forward(cfg, x, y, split.rebuild(values))
        ctx.cfg, ctx.split = cfg, split
        ctx.save_for_backward(x, y, *values)
        return val

    @staticmethod
    def backward(ctx, ct):
        cfg, split = ctx.cfg, ctx.split
        x, y, *values = ctx.saved_tensors
        lpacked, alpha_c = ctx.factor
        b, n = y.shape
        # O(n^3): the B inverses from the B factors, in one batched call
        kinv = torch.cholesky_inverse(tiling.unpack_lower(lpacked)[:, :n, :n])
        alpha = alpha_c.reshape(b, -1)[:, :n]
        params_d = _cast(split.rebuild(values), cfg.dtype, cfg.device)
        xd = x.to(cfg.dtype)
        per = [
            _nlml_dense_grads(cfg.kernel, km.gather_params(params_d, i, cfg.kernel), xd[i], alpha[i], kinv[i])
            for i in range(b)
        ]
        del kinv
        g_x = torch.stack([g[0] for g in per])
        g_y = torch.stack([g[1] for g in per])
        g_params = _stack_trees([g[2] for g in per])
        needs = ctx.needs_input_grad
        grads = [(ct * g).to(v) if need else None for g, v, need in zip(split.pick(g_params), values, needs[4:])]
        return (None, None, (ct[:, None, None] * g_x).to(x) if needs[2] else None,
                (ct[:, None] * g_y).to(y) if needs[3] else None, *grads)


def _batched_inputs(x, y, dtype, dev):
    """x (B, n, D) (or (B, n)) and y (B, n) as ``dtype`` tensors on ``dev``."""
    x = torch.as_tensor(x, device=dev).to(dtype)
    if x.ndim == 2:
        x = x[..., None]
    y = torch.as_tensor(y, device=dev).to(dtype)
    if x.ndim != 3 or y.ndim != 2 or x.shape[:2] != y.shape:
        raise ValueError(f"batched NLML needs x (B, n, D) and y (B, n); got {tuple(x.shape)}, {tuple(y.shape)}")
    return x, y


def nlml_tiled_batched(
    x,
    y,
    params,
    *,
    tile_size: int = 256,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=torch.float32,
    vjp: str = "custom",
    batch_dispatch: str = "flat",
    kernel=None,
    device="cuda",
) -> torch.Tensor:
    """The (B,) NLMLs of B stacked GPs, from ONE problem-batched program.

    x (B, n, D) / y (B, n); leaves shared or (B,).  Shared leaves are
    broadcast, so the gradient always comes back per problem.
    ``vjp="custom"`` takes the blocked reverse mode (analytic kernels; the
    others take ``"autodiff"``, through the program).
    """
    dev = resolve_device(device)
    x, y = _batched_inputs(x, y, dtype, dev)
    kernel = km.resolve_kernel(kernel)
    params = km.broadcast_params(params, x.shape[0], kernel, dtype=dtype, device=dev)
    cfg = _Config(int(tile_size), n_streams, update_dtype, dtype, kernel, dev, batch_dispatch)
    if vjp == "custom" and not kernel.analytic_vjp:
        vjp = "autodiff"
    if vjp == "custom":
        split = km.TensorLeaves(params)
        return _NLMLTiledBatched.apply(cfg, split, x, y, *split.values())
    if vjp == "autodiff":
        return _nlml_forward(cfg, x, y, params)[0]
    raise ValueError(f"vjp must be 'custom' or 'autodiff', got {vjp!r}")


# ---------------------------------------------------------------------------
# Low-rank (Nystrom / DTC) NLML: O(n m^2) per evaluation.
#
# Forward: the whitened inner system of repro_torch.core.lowrank (K_un
# through cov_tiles, c = K_un y through LRGEMM, chol(K_uu) and chol(B) on the
# tiled Cholesky).  With L = chol(K_uu + jitter I), W = L^-1 K_un, tau =
# s^-2, B = I + tau W W^T and c_w = W y, the value is taken whitened
# (lowrank.whitened_nlml):
#     NLML = 0.5 [tau y^T y - tau^2 c_w^T B^-1 c_w - n log tau + log det B + n log 2 pi]
# Backward (vjp="custom"): the blocked reverse mode, O(n m^2).  With
# g = B^-1 c_w:
#     G_W    = tau B^-1 W - tau^2 g (y - tau W^T g)^T
#     G_Kun  = L^-T G_W                      (the solve W = L^-1 K_un)
#     G_Kuu  = sym(L^-T Phi(L^T tril(-G_Kun W^T)) L^-1)   (through L = chol(K_uu))
#     g_tau  = 0.5 [y^T y - 2 tau c_w^T g + tau^2 |W^T g|^2 - n / tau + tr(B^-1 W W^T)]
#     g_s2   = -tau^2 g_tau,   g_y = tau (y - tau W^T g)
# (Phi: the lower triangle with the diagonal halved), and the kernel
# cotangents route through kfree_vjp.  The hyperparameters' small components
# (the vertical scale's, the lengthscale's) are differences of terms some
# 1e4 times larger at n in the hundreds of thousands, so the rule recomputes
# its pieces from (x, y, u) in float64, whatever the forward's dtype: K_uu,
# its factor, and W, B and g from one W (in float32 they lost the vertical
# component at n = 262144).  W is never held whole: the rule walks column
# blocks of K_un twice (B and c_w first, then the cotangents), with
# m x m accumulators.  The inducing inputs are fixed data (selected once from
# the detached x), so they take no cotangent.
# ---------------------------------------------------------------------------

# elements of one m x block piece of the low-rank rule's float64 walk (256 MiB)
LR_BLOCK_ELEMENTS = 1 << 25


@dataclasses.dataclass(frozen=True)
class _LowRankConfig:
    m_inducing: int
    tile_size: int
    jitter: float
    n_streams: Optional[int]
    update_dtype: Optional[torch.dtype]
    dtype: torch.dtype
    kernel: km.Kernel
    device: torch.device


def _lr_value(cfg: _LowRankConfig, x, y, u, params):
    state = lowrank.lowrank_state(
        x, y, params, cfg.m_inducing, cfg.tile_size, inducing=u, jitter=cfg.jitter,
        n_streams=cfg.n_streams, update_dtype=cfg.update_dtype, dtype=cfg.dtype,
        kernel=cfg.kernel, device=cfg.device,
    )
    return lowrank.whitened_nlml(state)


def _lr_grads(cfg: _LowRankConfig, x, y, u, params):
    """(g_x, g_y, g_params) of the low-rank NLML by the blocked rule, in float64 (see above)."""
    kernel, dev, dt = cfg.kernel, cfg.device, torch.float64
    p = _cast(params, dt, dev)
    ud, yd = u.to(dt), y.to(dt)
    n, mu = yd.shape[0], ud.shape[0]
    tau = 1.0 / torch.as_tensor(kernel.noise(p), dtype=dt, device=dev)
    eye = torch.eye(mu, dtype=dt, device=dev)
    # K_uu with the forward's diagonal: the kernel's diag plus the jitter
    kdiag = torch.as_tensor(kernel.diag(p), dtype=dt, device=dev) + cfg.jitter
    luu = torch.linalg.cholesky(torch.where(eye.bool(), kdiag, kernel.kfree(p, ud, ud)))
    step = max(1, LR_BLOCK_ELEMENTS // mu)
    blocks = [slice(s, min(s + step, n)) for s in range(0, n, step)]

    def whiten(b):
        return torch.linalg.solve_triangular(luu, kernel.kfree(p, ud, x[b].to(dt)), upper=False)

    gram = torch.zeros(mu, mu, dtype=dt, device=dev)  # W W^T
    c_w = torch.zeros(mu, dtype=dt, device=dev)
    for b in blocks:
        w = whiten(b)
        gram.addmm_(w, w.T)
        c_w.addmv_(w, yd[b])
    binv = torch.cholesky_inverse(torch.linalg.cholesky(eye + tau * gram))
    g = binv @ c_w
    g_tau = 0.5 * (torch.dot(yd, yd) - 2.0 * tau * torch.dot(c_w, g) + tau * tau * torch.dot(g, gram @ g)
                   - n / tau + torch.sum(binv * gram))
    del gram
    acc = torch.zeros(mu, mu, dtype=dt, device=dev)  # G_Kun W^T
    g_params, g_x, g_y = None, torch.empty_like(x, dtype=dt), torch.empty_like(yd)
    for b in blocks:
        w = whiten(b)
        resid = yd[b] - tau * (w.T @ g)
        g_kun = torch.linalg.solve_triangular(luu.T, tau * (binv @ w) - tau * tau * torch.outer(g, resid), upper=True)
        acc.addmm_(g_kun, w.T)
        del w
        gp_b, _, g_x[b] = kernel.kfree_vjp(p, ud, x[b].to(dt), g_kun)
        g_params = gp_b if g_params is None else km.tree_map(torch.add, g_params, gp_b)
        g_y[b] = tau * resid
        del g_kun
    phi = luu.T @ torch.tril(-acc)
    phi = torch.tril(phi) - 0.5 * torch.diag_embed(torch.diagonal(phi))
    left = torch.linalg.solve_triangular(luu.T, phi, upper=True)  # L^-T Phi
    g_kuu = torch.linalg.solve_triangular(luu.T, left.T, upper=True).T  # (L^-T Phi) L^-1
    gp_uu, _, _ = kernel.kfree_vjp(p, ud, ud, 0.5 * (g_kuu + g_kuu.T))
    g_params = km.tree_map(torch.add, g_params, gp_uu)
    g_params = dataclasses.replace(g_params, noise=g_params.noise - tau * tau * g_tau)
    return g_x, g_y, g_params


class _NLMLLowRank(torch.autograd.Function):
    """Forward: the Nystrom NLML; backward: the blocked O(n m^2) reverse mode, in float64."""

    @staticmethod
    def forward(ctx, cfg, split, x, y, u, *values):
        ctx.cfg, ctx.split = cfg, split
        ctx.save_for_backward(x, y, u, *values)
        return _lr_value(cfg, x, y, u, split.rebuild(values))

    @staticmethod
    def backward(ctx, ct):
        x, y, u, *values = ctx.saved_tensors
        g_x, g_y, g_params = _lr_grads(ctx.cfg, x, y, u, ctx.split.rebuild(values))
        needs = ctx.needs_input_grad
        grads = [(ct * g).to(v) if need else None for g, v, need in zip(ctx.split.pick(g_params), values, needs[5:])]
        return (None, None, (ct * g_x).to(x) if needs[2] else None, (ct * g_y).to(y) if needs[3] else None,
                None, *grads)


def nlml_lowrank(
    x,
    y,
    params,
    *,
    m_inducing: int,
    tile_size: int = 256,
    strategy: str = "subset",
    inducing=None,
    jitter=None,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=torch.float32,
    vjp: str = "custom",
    kernel=None,
    device="cuda",
) -> torch.Tensor:
    """Nystrom low-rank NLML, O(n m^2), differentiable in (x, y, params).

    ``vjp="custom"`` takes the blocked reverse mode (analytic-vjp kernels
    only; the others differentiate through the build).  The inducing set is
    selected once from the detached inputs and takes no gradient.
    """
    dev = resolve_device(device)
    x, y = _inputs(x, y, dtype, dev)
    kernel = km.resolve_kernel(kernel)
    jitter = lowrank.DEFAULT_JITTER if jitter is None else float(jitter)
    u, _ = lowrank.select_inducing(x.detach(), m_inducing, strategy=strategy, inducing=inducing)
    cfg = _LowRankConfig(int(m_inducing), int(tile_size), jitter, n_streams, update_dtype, dtype, kernel, dev)
    if vjp == "custom" and not kernel.analytic_vjp:
        vjp = "autodiff"
    if vjp == "custom":
        split = km.TensorLeaves(params)
        return _NLMLLowRank.apply(cfg, split, x, y, u, *split.values())
    if vjp == "autodiff":
        return _lr_value(cfg, x, y, u, params)
    raise ValueError(f"vjp must be 'custom' or 'autodiff', got {vjp!r}")


def nlml_lowrank_batched(
    x,
    y,
    params,
    *,
    m_inducing: int,
    tile_size: int = 256,
    strategy: str = "subset",
    inducing=None,
    jitter=None,
    n_streams: Optional[int] = None,
    update_dtype=None,
    dtype=torch.float32,
    batch_dispatch: str = "flat",
    n_valid=None,
    kernel=None,
    device="cuda",
) -> torch.Tensor:
    """The (B,) low-rank NLMLs of B stacked problems of one size, from one batched build.

    Differentiated by autograd through the build (the blocked rule is
    single-problem); the value is the whitened one (:func:`lowrank.whitened_nlml`).
    ``n_valid`` (B,) marks zero-padded ragged problems: each NLML is then
    that of the problem's own rows.
    """
    dev = resolve_device(device)
    x, y = _batched_inputs(x, y, dtype, dev)
    kernel = km.resolve_kernel(kernel)
    state = lowrank.lowrank_state(
        x, y, params, m_inducing, tile_size, strategy=strategy, inducing=inducing,
        jitter=lowrank.DEFAULT_JITTER if jitter is None else float(jitter),
        n_streams=n_streams, update_dtype=update_dtype, dtype=dtype,
        batch_dispatch=batch_dispatch, n_valid=n_valid, kernel=kernel, device=dev,
    )
    return lowrank.whitened_nlml(state)


# ---------------------------------------------------------------------------
# Unconstrained-space packing and the Adam optimizer.
# ---------------------------------------------------------------------------


def _softplus(z: torch.Tensor) -> torch.Tensor:
    # softplus keeps hyperparameters positive; logaddexp is overflow-safe
    return torch.logaddexp(z, torch.zeros_like(z))


def _inv_softplus(p: torch.Tensor) -> torch.Tensor:
    """Numerically stable softplus inverse, exact from tiny up to the dtype's max.

    ``log(expm1(p))`` overflows expm1 for large p and ``p + log1p(-exp(-p))``
    loses to ``exp(-p) == 1`` rounding for tiny p, so: branch at 20, each arm
    clamped into its own safe range (no NaN gradient from the untaken arm),
    and p floored at the dtype's tiny.
    """
    p = torch.clamp(p, min=torch.finfo(p.dtype).tiny)
    small = torch.log(torch.expm1(torch.clamp(p, max=20.0)))
    big = p + torch.log1p(-torch.exp(-torch.clamp(p, min=20.0)))
    return torch.where(p > 20.0, big, small)


def _leaf_dtype(params, dtype):
    """``dtype``, or the promoted dtype of the tensor leaves (the default dtype for floats)."""
    if dtype is not None:
        return dtype
    found = [l.dtype for l in km.tree_leaves(params) if isinstance(l, torch.Tensor)]
    out = found[0] if found else torch.get_default_dtype()
    for d in found[1:]:
        out = torch.promote_types(out, d)
    return out


def unpack_params(raw):
    """Softplus every leaf of an unconstrained params tree."""
    return km.tree_map(_softplus, raw)


def pack_params(params, dtype=None, device=None):
    """Inverse-softplus every leaf of a params tree (every family keeps its leaves positive)."""
    dtype = _leaf_dtype(params, dtype)
    return km.tree_map(lambda p: _inv_softplus(torch.as_tensor(p, dtype=dtype, device=device)), params)


def _unpack(raw: torch.Tensor) -> km.SEKernelParams:
    # raw is (..., 3): the SE triple on the last axis
    return km.SEKernelParams(
        lengthscale=_softplus(raw[..., 0]), vertical=_softplus(raw[..., 1]), noise=_softplus(raw[..., 2]),
    )


def _pack(params: km.SEKernelParams, dtype=None, device=None) -> torch.Tensor:
    """Inverse softplus into (..., 3); ``dtype=None`` keeps the leaves' common dtype."""
    dtype = _leaf_dtype(params, dtype)
    leaves = [torch.as_tensor(p, dtype=dtype, device=device) for p in (params.lengthscale, params.vertical, params.noise)]
    return torch.stack([_inv_softplus(p) for p in leaves], dim=-1)


def _raw_codec(kernel):
    """(pack, unpack) of a kernel's unconstrained parameterization.

    SE keeps the stacked (..., 3) raw layout; every other family round-trips
    its whole params tree leaf by leaf.
    """
    if isinstance(kernel, km.SquaredExponential):
        return _pack, _unpack
    return pack_params, unpack_params


def nlml_loss_fn(
    x,
    y,
    *,
    method: str = "monolithic",
    dtype=torch.float32,
    tile_size: int = 256,
    n_streams: Optional[int] = None,
    update_dtype=None,
    vjp: str = "custom",
    kernel=None,
    m_inducing=None,
    strategy: str = "subset",
    inducing=None,
    jitter=None,
    device="cuda",
):
    """loss(raw) over unconstrained hyperparameters, for any NLML path."""
    kernel = km.resolve_kernel(kernel)
    _, unpack = _raw_codec(kernel)
    if method == "monolithic":
        return lambda raw: negative_log_marginal_likelihood(
            x, y, unpack(raw), dtype=dtype, kernel=kernel, device=device
        )
    if method == "tiled":
        return lambda raw: nlml_tiled(
            x, y, unpack(raw), tile_size=tile_size, n_streams=n_streams, update_dtype=update_dtype,
            dtype=dtype, vjp=vjp, kernel=kernel, device=device,
        )
    if method == "lowrank":
        if m_inducing is None:
            raise ValueError("method='lowrank' needs m_inducing")
        return lambda raw: nlml_lowrank(
            x, y, unpack(raw), m_inducing=m_inducing, tile_size=tile_size, strategy=strategy,
            inducing=inducing, jitter=jitter, n_streams=n_streams, update_dtype=update_dtype,
            dtype=dtype, vjp=vjp, kernel=kernel, device=device,
        )
    raise ValueError(f"method must be 'monolithic', 'tiled' or 'lowrank', got {method!r}")


def _adam(objective, raw0, steps: int, lr: float):
    """Adam on ``objective(raw) -> (value to differentiate, value to record)`` from ``raw0``.

    The update is the reference's ``_adam_scan_impl`` written out per leaf:
    b1 = 0.9, b2 = 0.999, eps = 1e-8, bias corrections taken at t = 1 ...
    steps in the raw leaves' dtype.  It is elementwise, so (B, ...) leaves
    with a summed objective are B independent optimizers.
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    leaves, treedef = km.tree_flatten(raw0)
    raw = [l.detach() for l in leaves]
    m = [torch.zeros_like(r) for r in raw]
    v = [torch.zeros_like(r) for r in raw]
    ts = torch.arange(1, steps + 1, dtype=raw[0].dtype, device=raw[0].device)
    losses = []
    for i in range(steps):
        live = [r.detach().requires_grad_() for r in raw]
        val, report = objective(km.tree_unflatten(treedef, live))
        g = torch.autograd.grad(val, live)
        losses.append(report.detach())
        t = ts[i]
        with torch.no_grad():
            m = [b1 * m_ + (1 - b1) * g_ for m_, g_ in zip(m, g)]
            v = [b2 * v_ + (1 - b2) * g_ * g_ for v_, g_ in zip(v, g)]
            raw = [r - lr * (m_ / (1 - b1**t)) / (torch.sqrt(v_ / (1 - b2**t)) + eps)
                   for r, m_, v_ in zip(raw, m, v)]
    return km.tree_unflatten(treedef, raw), torch.stack(losses)


def adam(loss, raw0, steps: int, lr: float):
    """Adam on ``loss(raw)`` from ``raw0`` (any tree of tensors): (raw_final, losses).

    ``losses[t]`` is the loss before update t (``losses[0]`` at the initial
    point).
    """

    def objective(raw):
        val = loss(raw)
        return val, val

    return _adam(objective, raw0, steps, lr)


def adam_batched(loss, raw0, steps: int, lr: float):
    """B independent Adam runs side by side: ``loss(raw)`` gives the (B,) losses.

    The gradient of the sum of independent per-problem losses is the
    stacked per-problem gradients, and the update is elementwise, so one
    set of (B, ...) moments is B optimizers.  Returns (raw_final, losses
    (steps, B)), the losses before each update as :func:`adam` records them.
    """

    def objective(raw):
        val = loss(raw)
        return torch.sum(val), val

    return _adam(objective, raw0, steps, lr)


def adam_scan(loss, steps: int, lr: float):
    """The reference's name and call form: ``adam_scan(loss, steps, lr)(raw0)`` is ``adam(loss, raw0, steps, lr)``.

    Returns the function ``raw0 -> (raw_final, losses)``; the steps run as
    a Python loop of eager updates (there is no trace to compile here).
    """
    return lambda raw0: adam(loss, raw0, steps, lr)


def adam_scan_batched(loss, steps: int, lr: float):
    """The reference's name and call form of :func:`adam_batched`: ``raw0 -> (raw_final, losses (steps, B))``."""
    return lambda raw0: adam_batched(loss, raw0, steps, lr)


def optimize_hyperparameters(
    x,
    y,
    init,
    *,
    steps: int = 100,
    lr: float = 0.05,
    dtype=torch.float32,
    method: str = "monolithic",
    tile_size: int = 256,
    n_streams: Optional[int] = None,
    update_dtype=None,
    vjp: str = "custom",
    kernel=None,
    m_inducing=None,
    strategy: str = "subset",
    inducing=None,
    jitter=None,
    device="cuda",
) -> Tuple:
    """Adam on the NLML in unconstrained space.  Returns (params, loss curve).

    ``method="monolithic"`` differentiates the dense reference NLML,
    ``"tiled"`` the tiled program (:func:`nlml_tiled`: no dense Cholesky in
    the loop), ``"lowrank"`` the Nystrom NLML (:func:`nlml_lowrank`, needs
    ``m_inducing``).  ``init`` is the kernel's params tree.
    """
    dev = resolve_device(device)
    x, y = _inputs(x, y, dtype, dev)
    kernel = km.resolve_kernel(kernel)
    pack, unpack = _raw_codec(kernel)
    loss = nlml_loss_fn(
        x, y, method=method, dtype=dtype, tile_size=tile_size, n_streams=n_streams,
        update_dtype=update_dtype, vjp=vjp, kernel=kernel, m_inducing=m_inducing, strategy=strategy,
        inducing=inducing, jitter=jitter, device=dev,
    )
    raw, losses = adam(loss, pack(init, dtype=dtype, device=dev), steps, lr)
    with torch.no_grad():
        return unpack(raw), losses


def optimize_hyperparameters_batched(
    x,
    y,
    init,
    *,
    steps: int = 100,
    lr: float = 0.05,
    dtype=torch.float32,
    method: str = "tiled",
    tile_size: int = 256,
    n_streams: Optional[int] = None,
    update_dtype=None,
    vjp: str = "custom",
    batch_dispatch: str = "flat",
    kernel=None,
    m_inducing=None,
    strategy: str = "subset",
    inducing=None,
    jitter=None,
    n_valid=None,
    device="cuda",
) -> Tuple:
    """Train B problems' hyperparameters side by side (independent Adam moments per problem).

    x (B, n, D) / y (B, n); ``init`` leaves shared (one start for all) or
    (B,).  Returns (params with (B,) leaves, loss curves (steps, B)).
    ``method="tiled"`` evaluates the B NLMLs through one problem-batched
    program a step (:func:`nlml_tiled_batched`), ``"lowrank"`` the Nystrom
    NLMLs (:func:`nlml_lowrank_batched`, needs ``m_inducing``; ``n_valid``
    (B,) trains zero-padded ragged problems on their own rows, as the
    reference passes it to the low-rank loss), ``"monolithic"`` the dense
    reference per problem.
    """
    dev = resolve_device(device)
    x, y = _batched_inputs(x, y, dtype, dev)
    b = x.shape[0]
    kernel = km.resolve_kernel(kernel)
    pack, unpack = _raw_codec(kernel)
    init = km.broadcast_params(init, b, kernel, dtype=dtype, device=dev)
    if method == "tiled":
        def loss(raw):
            return nlml_tiled_batched(
                x, y, unpack(raw), tile_size=tile_size, n_streams=n_streams, update_dtype=update_dtype,
                dtype=dtype, vjp=vjp, batch_dispatch=batch_dispatch, kernel=kernel, device=dev,
            )
    elif method == "lowrank":
        if m_inducing is None:
            raise ValueError("method='lowrank' needs m_inducing")

        def loss(raw):
            return nlml_lowrank_batched(
                x, y, unpack(raw), m_inducing=m_inducing, tile_size=tile_size, strategy=strategy,
                inducing=inducing, jitter=jitter, n_streams=n_streams, update_dtype=update_dtype,
                dtype=dtype, batch_dispatch=batch_dispatch, n_valid=n_valid, kernel=kernel, device=dev,
            )
    elif method == "monolithic":
        def loss(raw):
            p = unpack(raw)
            return torch.stack([
                negative_log_marginal_likelihood(
                    x[i], y[i], km.gather_params(p, i, kernel), dtype=dtype, kernel=kernel, device=dev
                )
                for i in range(b)
            ])
    else:
        raise ValueError(f"method must be 'monolithic', 'tiled' or 'lowrank', got {method!r}")
    raw, losses = adam_batched(loss, pack(init, dtype=dtype, device=dev), steps, lr)
    with torch.no_grad():
        return unpack(raw), losses
