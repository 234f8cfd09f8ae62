"""Carry hyperparameters and cached states across from the JAX package.

The JAX package's ``SEKernelParams``, ``PosteriorState`` and
``LowRankState`` hold JAX arrays;
the caller hands their leaves over as numpy arrays (``np.asarray(leaf)``),
so this module needs neither JAX nor the ``repro`` package.  The tensors it
builds keep the numpy dtypes and go to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import executor
from repro_torch.core import kernels_math as km
from repro_torch.core.lowrank import LowRankState
from repro_torch.core.predict import PosteriorState
from repro_torch.device import resolve_device


def params_from_numpy(lengthscale, vertical, noise) -> km.SEKernelParams:
    """SE hyperparameters from the leaves of the JAX ``SEKernelParams``.

    Each leaf (a numpy scalar, 0-d array or Python float) becomes a Python
    float, the form the port's kernels take as runtime scalars.
    """
    return km.SEKernelParams(
        float(np.asarray(lengthscale)), float(np.asarray(vertical)), float(np.asarray(noise))
    )


def posterior_state_from_numpy(
    lpacked,
    alpha,
    x_chunks,
    n: int,
    m: int,
    params: km.SEKernelParams,
    beta=None,
    y_chunks=None,
    *,
    kernel=None,
    device="cuda",
) -> PosteriorState:
    """The port's :class:`PosteriorState` from the fields of a JAX one.

    ``lpacked`` (T, m, m), ``alpha`` (M, m), ``x_chunks`` (M, m, D) and the
    optional ``beta`` / ``y_chunks`` (M, m) are numpy arrays; ``params``
    comes from :func:`params_from_numpy`.
    """
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    lp, al, xc = t(lpacked), t(alpha), t(x_chunks)
    m_tiles = xc.shape[0]
    if lp.shape != (m_tiles * (m_tiles + 1) // 2, m, m) or al.shape != (m_tiles, m):
        raise ValueError(
            f"inconsistent state: lpacked {tuple(lp.shape)}, alpha {tuple(al.shape)}, "
            f"x_chunks {tuple(xc.shape)} for tile size {m}"
        )
    return PosteriorState(
        lpacked=lp, alpha=al, x_chunks=xc, n=int(n), m=int(m), params=params,
        beta=t(beta), y_chunks=t(y_chunks), kernel=km.resolve_kernel(kernel),
    )


def lowrank_state_from_numpy(
    u_chunks,
    luu_packed,
    b_packed,
    lb_packed,
    c_chunks,
    gamma,
    yty,
    n: int,
    m: int,
    m_inducing: int,
    params: km.SEKernelParams,
    jitter: float,
    mu_valid=None,
    *,
    kernel=None,
    device="cuda",
) -> LowRankState:
    """The port's :class:`LowRankState` from the fields of a single-problem JAX one.

    ``u_chunks`` (MU, m, D), the packed (T, m, m) stores ``luu_packed``,
    ``b_packed`` and ``lb_packed``, ``c_chunks`` / ``gamma`` (MU, m) and the
    scalar ``yty`` are numpy arrays; ``mu_valid`` is None or the count of
    distinct inducing points; ``params`` comes from :func:`params_from_numpy`.
    The field the port adds, ``c_w = L_uu^-1 c``, is solved from them.
    """
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    uc, c, g = t(u_chunks), t(c_chunks), t(gamma)
    stores = [t(a) for a in (luu_packed, b_packed, lb_packed)]
    mu_tiles = uc.shape[0]
    shape = (mu_tiles * (mu_tiles + 1) // 2, m, m)
    if any(a.shape != shape for a in stores) or c.shape != (mu_tiles, m) or g.shape != c.shape:
        raise ValueError(
            f"inconsistent state: u_chunks {tuple(uc.shape)}, stores "
            f"{[tuple(a.shape) for a in stores]}, c_chunks {tuple(c.shape)}, gamma "
            f"{tuple(g.shape)} for tile size {m}"
        )
    return LowRankState(
        u_chunks=uc, luu_packed=stores[0], b_packed=stores[1], lb_packed=stores[2],
        c_chunks=c, gamma=g, c_w=executor.run_solve(stores[0], c, lower=True, device=dev),
        yty=t(yty).reshape(()), n=int(n), m=int(m),
        m_inducing=int(m_inducing), params=params, jitter=float(jitter),
        mu_valid=None if mu_valid is None else int(np.asarray(mu_valid)),
        kernel=km.resolve_kernel(kernel),
    )
