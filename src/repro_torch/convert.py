"""Carry hyperparameters and a cached posterior across from the JAX package.

The JAX package's ``SEKernelParams`` and ``PosteriorState`` hold JAX arrays;
the caller hands their leaves over as numpy arrays (``np.asarray(leaf)``),
so this module needs neither JAX nor the ``repro`` package.  The tensors it
builds keep the numpy dtypes and go to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kernels_math as km
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
