"""Mamba-2 block: the SSD (state-space duality) chunked algorithm.

The counterpart of ``repro/models/mamba2.py``: the Mamba-2 mixer
(arXiv:2405.21060), an input projection to (z, x, B, C, dt), a short causal
conv with SiLU on (x, B, C), and a scalar-identity SSM with per-head decay
a_t = exp(Δ_t·A), evaluated in chunks:

  * intra-chunk: the (c × c) decay-masked C·Bᵀ scores of each chunk;
  * inter-chunk: each chunk's final state carried by ``layers.linear_scan``.

Sequence mode returns the final SSM state, so that prefill seeds decoding;
decode is one constant-size step, updated in place.  Decay and exp run in
float32; the contractions' operands follow the reference's types.

**Chunks.**  When S is not a multiple of ``ssm_chunk`` the reference falls
back to the largest divisor of S (3 at S = 2049), whose chunk states grow
as S / c.  The port keeps c = min(ssm_chunk, S) and pads the last chunk
with tokens whose Δ, x, B and C are 0: each has decay 1 and input 0, so
every real output and the final state are those of the unpadded sequence
in exact arithmetic.

The conv state after a prompt shorter than ``conv_width - 1`` is
left-padded with zeros (``rglru.conv_state``; ROADMAP.md §3 item 4).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _param, fill_, init_param_, linear_scan
from repro_torch.models.rglru import _causal_conv, conv_state


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state


class Mamba2(nn.Module):
    """``w_in`` (d, 2 d_in + 2 N + H), ``conv_w`` (cw, d_in + 2 N), ``conv_b``, float32 ``a_log``/``d_skip``/
    ``dt_bias`` (H,), ``norm_scale`` (d_in,), ``w_out`` (d_in, d)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, n = _dims(cfg)
        self.w_in = _param((d, 2 * d_in + 2 * n + h), dtype, device)
        self.conv_w = _param((cfg.conv_width, d_in + 2 * n), dtype, device)
        self.conv_b = _param((d_in + 2 * n,), dtype, device, 0.0)
        self.a_log = _param((h,), torch.float32, device)
        self.d_skip = _param((h,), torch.float32, device, 1.0)
        self.dt_bias = _param((h,), torch.float32, device)
        self.norm_scale = _param((d_in,), dtype, device, 1.0)
        self.w_out = _param((d_in, d), dtype, device)


def init_mamba2_(p: Mamba2, generator: torch.Generator) -> Mamba2:
    """Draw the weights in place at the reference's scales: A ∈ [1, 16], Δ₀ log-uniform in [1e-3, 0.1]."""
    d = p.w_in.shape[0]
    d_in = p.w_out.shape[0]
    h = p.a_log.shape[0]
    dev = generator.device
    init_param_(p.w_in, generator, 1.0 / math.sqrt(d))
    init_param_(p.conv_w, generator, 1.0 / math.sqrt(p.conv_w.shape[0]))
    init_param_(p.w_out, generator, 1.0 / math.sqrt(d_in))
    fill_(p.a_log, torch.log(1.0 + 15.0 * torch.rand((h,), generator=generator, device=dev)))
    dt0 = torch.exp(torch.rand((h,), generator=generator, device=dev) * (math.log(0.1) - math.log(0.001))
                    + math.log(0.001))
    fill_(p.dt_bias, dt0 + torch.log(-torch.expm1(-dt0)))  # inverse softplus
    return p


def _split_proj(p: Mamba2, x: torch.Tensor, cfg: ModelConfig):
    d_in, h, _, n = _dims(cfg)
    return torch.split(x @ p.w_in, [d_in, d_in, n, n, h], dim=-1)


def _gated_out(p: Mamba2, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y * silu(z)) @ w_out."""
    g = (y * nn.functional.silu(z)).float()
    g = g * torch.rsqrt(torch.mean(g * g, -1, keepdim=True) + 1e-6)
    return (g.to(y.dtype) * p.norm_scale) @ p.w_out


def apply_mamba2_seq(p: Mamba2, x_in: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """x_in (B, S, d) -> (out (B, S, d), the state for decode continuation)."""
    b, s, _ = x_in.shape
    d_in, h, pd, n = _dims(cfg)
    c = min(cfg.ssm_chunk, s)
    nc = -(-s // c)
    pad = nc * c - s

    z, xc, bm, cm, dt_raw = _split_proj(p, x_in, cfg)
    xbc_pre = torch.cat([xc, bm, cm], -1)                          # pre-conv (decode state)
    xc, bm, cm = torch.split(nn.functional.silu(_causal_conv(xbc_pre, p.conv_w, p.conv_b)), [d_in, n, n], dim=-1)
    dt = nn.functional.softplus(dt_raw.float() + p.dt_bias)        # (B, S, H)
    da = -torch.exp(p.a_log) * dt                                   # (B, S, H) <= 0
    xh = xc.reshape(b, s, h, pd)

    def chunked(t):  # (B, S, ...) -> (B, NC, c, ...), the padding tokens zero
        t = nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape((b, nc, c) + tuple(t.shape[2:]))

    xz, dtz, daz, bz, cz = (chunked(t) for t in (xh, dt, da, bm, cm))
    cs = torch.cumsum(daz, dim=2)                                   # (B, NC, c, H)

    # intra-chunk: the quadratic, decay-masked attention form
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]                # (B, NC, i, j, H)
    above = torch.ones((c, c), dtype=torch.bool, device=x_in.device).triu(1)[:, :, None]
    # exp of -inf above the diagonal: the reference's where(tril, exp(li), 0) in the forward, without its
    # 0 * inf = NaN gradient where li = -(sum of da) above the diagonal overflows exp
    lmask = torch.exp(li.masked_fill(above, float("-inf")))
    scores = torch.einsum("bzin,bzjn->bzij", cz, bz)
    dtx = xz * dtz[..., None].to(xz.dtype)                          # (B, NC, c, H, P)
    y_diag = torch.einsum("bzij,bzijh,bzjhp->bzihp", scores.float(), lmask, dtx.float())

    # chunk states, and the recurrence over chunks
    decay_states = torch.exp(cs[:, :, -1:, :] - cs)                 # (B, NC, c, H)
    sstates = torch.einsum("bzjn,bzjh,bzjhp->bzhnp", bz.float(), decay_states * dtz, xz.float())
    h_inc = linear_scan(torch.exp(cs[:, :, -1, :]), sstates)       # (B, NC, H, N, P)
    h_prev = torch.cat([torch.zeros_like(h_inc[:, :1]), h_inc[:, :-1]], dim=1)  # exclusive
    y_off = torch.einsum("bzin,bzhnp->bzihp", cz.float(), h_prev) * torch.exp(cs)[..., None]

    y = (y_diag + y_off).reshape(b, nc * c, h, pd)[:, :s]
    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = y.to(x_in.dtype).reshape(b, s, d_in)
    out = _gated_out(p, y, z)
    return out, {"h": h_inc[:, -1].clone(), "conv": conv_state(xbc_pre, cfg.conv_width)}


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    d_in, h, pd, n = _dims(cfg)
    return {"h": torch.zeros((batch, h, n, pd), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * n), dtype=dtype, device=device)}


def apply_mamba2_step(p: Mamba2, x_in: torch.Tensor, state: dict, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One token: x_in (B, 1, d), an O(H N P) state update; ``state`` is updated in place and returned."""
    b = x_in.shape[0]
    d_in, h, pd, n = _dims(cfg)
    z, xc, bm, cm, dt_raw = _split_proj(p, x_in, cfg)
    window = torch.cat([state["conv"], torch.cat([xc, bm, cm], -1)], dim=1)  # (B, cw, .), oldest first
    # the sequence conv applies conv_w[0] to the newest tap
    xbc = nn.functional.silu(torch.einsum("bcw,cw->bw", window, p.conv_w.flip(0)) + p.conv_b)
    xc1, bm1, cm1 = torch.split(xbc, [d_in, n, n], dim=-1)
    xh = xc1.reshape(b, h, pd).float()
    dt = nn.functional.softplus(dt_raw[:, 0].float() + p.dt_bias)  # (B, H)
    a = torch.exp(-torch.exp(p.a_log) * dt)
    hnew = a[..., None, None] * state["h"] + torch.einsum("bn,bhp->bhnp", bm1.float(), xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", cm1.float(), hnew) + p.d_skip[None, :, None] * xh
    out = _gated_out(p, y.reshape(b, 1, d_in).to(x_in.dtype), z)
    state["h"].copy_(hnew)
    state["conv"].copy_(window[:, 1:])
    return out, state
