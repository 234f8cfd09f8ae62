"""Shared layer primitives: norms, MLPs, rotary embeddings, initializers.

The counterpart of ``repro/models/layers.py``.  Parameters live in
``nn.Module``s (:class:`Norm`, :class:`MLP`) in the JAX package's layout
(``w_gate`` (d, ff), ``w_down`` (ff, d), ...), and the ``apply_*``
functions take the module where the JAX functions take the parameter dict.
Norms and softmax-adjacent math run in float32 whatever the activation
type, as in the reference.  The sharding hint ``constrain`` has no
counterpart: it does nothing without a mesh, and the port's meshes lay out
whole leaves (``dist.sharding``).  Parameters are made with
``requires_grad=False``; training turns it on for the step
(``train.train_step.loss_and_grads``).  :func:`linear_scan` is the
recurrent kinds' ``associative_scan``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn


def trunc_normal(generator: torch.Generator, shape, scale: float, dtype, device=None) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], drawn on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (scale * t).to(device=device if device is not None else generator.device, dtype=dtype)


def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def fill_(param: torch.Tensor, value: torch.Tensor) -> None:
    """Copy ``value`` into a parameter (cast to its type and device)."""
    with torch.no_grad():
        param.copy_(value)


def init_param_(param: torch.Tensor, generator: torch.Generator, scale: float) -> None:
    """Fill a parameter with :func:`trunc_normal` draws at ``scale``."""
    fill_(param, trunc_normal(generator, param.shape, scale, param.dtype, param.device))


# ---------------------------------------------------------------------------
# Norms.  kind: rmsnorm | layernorm | layernorm_np (non-parametric, OLMo)
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """rmsnorm (``scale``, applied as 1 + scale), layernorm (``scale``, ``bias``) or layernorm_np."""

    def __init__(self, kind: str, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.kind = kind
        if kind == "rmsnorm":
            self.scale = _param((d,), dtype, device, 0.0)
        elif kind == "layernorm":
            self.scale = _param((d,), dtype, device, 1.0)
            self.bias = _param((d,), dtype, device, 0.0)
        elif kind != "layernorm_np":
            raise ValueError(kind)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self, x, self.kind)


def init_norm(kind: str, d: int, dtype, device=None) -> Norm:
    return Norm(kind, d, dtype, device)


def apply_norm(p: Norm, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
        out = x32 * (1.0 + p.scale.float())
    elif kind in ("layernorm", "layernorm_np"):
        mu = torch.mean(x32, -1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), -1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            out = out * p.scale.float() + p.bias.float()
    else:
        raise ValueError(kind)
    return out.to(dt)


# ---------------------------------------------------------------------------
# MLPs.  swiglu / geglu: gated two-matrix up-projection; gelu: plain.
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, kind: str, d: int, ff: int, dtype=torch.float32, device=None):
        super().__init__()
        self.kind = kind
        if kind in ("swiglu", "geglu"):
            self.w_gate = _param((d, ff), dtype, device)
        elif kind != "gelu":
            raise ValueError(kind)
        self.w_up = _param((d, ff), dtype, device)
        self.w_down = _param((ff, d), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, x, self.kind)


def init_mlp(generator: torch.Generator, kind: str, d: int, ff: int, dtype, device=None) -> MLP:
    return init_mlp_(MLP(kind, d, ff, dtype, device), generator)


def init_mlp_(mlp: MLP, generator: torch.Generator) -> MLP:
    """Draw an MLP's weights in place: 1/sqrt(d) into the up projections, 1/sqrt(ff) out."""
    d, ff = mlp.w_up.shape
    for name in ("w_gate", "w_up") if mlp.kind in ("swiglu", "geglu") else ("w_up",):
        init_param_(getattr(mlp, name), generator, 1.0 / math.sqrt(d))
    init_param_(mlp.w_down, generator, 1.0 / math.sqrt(ff))
    return mlp


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return nn.functional.gelu(v, approximate="tanh")


def apply_mlp(p: MLP, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        act = nn.functional.silu if kind == "swiglu" else _gelu_tanh
        return (act(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    if kind == "gelu":
        return _gelu_tanh(x @ p.w_up) @ p.w_down
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings (full or partial head-dim fraction).
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, fraction: float, theta: float, device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(
    x: torch.Tensor,              # (B, S, H, hd)
    positions: torch.Tensor,      # (B, S) integer
    *,
    fraction: float = 1.0,
    theta: float = 10000.0,
) -> torch.Tensor:
    """Rotate interleaved pairs (x[2i], x[2i+1]) of the first ``fraction`` of the head."""
    hd = x.shape[-1]
    inv, rot = rope_frequencies(hd, fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv                      # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rot < hd:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out


def sinusoidal_pos_emb(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) -> (B, S, d) classic transformer sinusoids (MusicGen-style)."""
    half = d // 2
    freq = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Linear recurrences (RG-LRU, Mamba-2's inter-chunk states).
# ---------------------------------------------------------------------------


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h = 0: every h_t, in ⌈log2 S⌉ elementwise passes.

    The counterpart of ``jax.lax.associative_scan`` over ``(a, b) -> (a_l a_r,
    a_r b_l + b_r)`` (Hillis-Steele doubling: pass k combines each step with
    the one 2^k before it), returning the ``b`` half.  ``a`` is ``b``'s
    leading dims (Mamba-2 scans (B, NC, H, N, P) chunk states with a (B, NC,
    H) decay): it broadcasts over ``b``'s trailing ones.  It differs from
    JAX's scan only in the order of the products.
    """
    if a.ndim < 2 or b.shape[:a.ndim] != a.shape:
        raise ValueError(f"linear_scan: a {tuple(a.shape)} must be the leading dims of b {tuple(b.shape)}")
    n, tail = b.shape[1], (None,) * (b.ndim - a.ndim)
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:][(...,) + tail] * b[:, :-d] + b[:, d:]], 1)
        if 2 * d < n:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float.

    The reference multiplies by ``jnp.asarray(value, dtype)``; multiplying by
    this float gives the same product without a device tensor (building one
    from a Python number copies it to the card and waits for the stream).
    """
    return float(torch.tensor(value, dtype=dtype))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def as_generator(generator: Union[torch.Generator, int], device) -> torch.Generator:
    """A generator on ``device``; an int seeds a new one."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))
