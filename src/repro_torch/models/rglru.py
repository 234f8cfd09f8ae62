"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The counterpart of ``repro/models/rglru.py``.  Two parallel projections of
the input: a GeLU gate branch, and a recurrence branch that passes through
a short causal depthwise conv and the Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(x_t W_a + b_a)            recurrence gate
    i_t = sigmoid(x_t W_x + b_x)            input gate
    a_t = exp(-c * softplus(Λ) * r_t)       per-channel decay (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Sequence mode evaluates the recurrence with ``layers.linear_scan`` (log
depth, float32); decode is one step carrying ``{"h", "conv"}``, updated in
place.  The parameters sit in an :class:`RGLRU` module under the
reference's names; Λ is ``lambda``, a Python keyword, so it is registered
by name and read with ``getattr``.

The decode state's ``conv`` holds the last ``conv_width - 1`` pre-conv
projections.  After a prompt shorter than that, the reference keeps fewer
rows and its decode step fails on the window's shape; the port left-pads
them with zeros, the taps the sequence conv reads as padding (ROADMAP.md
§3 item 4).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _gelu_tanh, _param, fill_, init_param_, linear_scan

_C = 8.0


class RGLRU(nn.Module):
    """``w_gate_branch``/``w_x_branch`` (d, w), ``conv_w`` (cw, w), ``conv_b``, ``w_a``/``w_i`` (w, w),
    float32 ``b_a``/``b_i``/``lambda`` (w,), ``w_out`` (w, d)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d, w, cw = cfg.d_model, cfg.rnn_width_, cfg.conv_width
        self.w_gate_branch = _param((d, w), dtype, device)
        self.w_x_branch = _param((d, w), dtype, device)
        self.conv_w = _param((cw, w), dtype, device)
        self.conv_b = _param((w,), dtype, device, 0.0)
        self.w_a = _param((w, w), dtype, device)
        self.b_a = _param((w,), torch.float32, device, 0.0)
        self.w_i = _param((w, w), dtype, device)
        self.b_i = _param((w,), torch.float32, device, 0.0)
        self.register_parameter("lambda", _param((w,), torch.float32, device))
        self.w_out = _param((w, d), dtype, device)


def init_rglru_(p: RGLRU, generator: torch.Generator) -> RGLRU:
    """Draw the weights in place at the reference's scales; Λ so that a ∈ (0.9, 0.999) at r = 1."""
    d, w = p.w_gate_branch.shape
    cw = p.conv_w.shape[0]
    for name in ("w_gate_branch", "w_x_branch"):
        init_param_(getattr(p, name), generator, 1.0 / math.sqrt(d))
    init_param_(p.conv_w, generator, 1.0 / math.sqrt(cw))
    for name in ("w_a", "w_i", "w_out"):
        init_param_(getattr(p, name), generator, 1.0 / math.sqrt(w))
    u = 0.9 + 0.099 * torch.rand((w,), generator=generator, device=generator.device)
    fill_(getattr(p, "lambda"), torch.log(torch.expm1(-torch.log(u) / _C)))
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, W), w (cw, W); tap i reads the token i back."""
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(w.shape[0]):
        out = out + nn.functional.pad(x, (0, 0, i, 0))[:, :s] * w[i]
    return out + b


def _gates(p: RGLRU, xb: torch.Tensor):
    """(a, b) of the recurrence, float32."""
    x32 = xb.float()
    r = torch.sigmoid(x32 @ p.w_a.float() + p.b_a)
    i = torch.sigmoid(x32 @ p.w_i.float() + p.b_i)
    a = torch.exp(-_C * nn.functional.softplus(getattr(p, "lambda")) * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x32)


def conv_state(pre: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` rows of a pre-conv (B, S, C) sequence, left-padded with zeros when S is shorter."""
    keep = width - 1
    return nn.functional.pad(pre[:, -keep:], (0, 0, max(0, keep - pre.shape[1]), 0)).clone()


def apply_rglru_seq(p: RGLRU, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), the state for decode continuation)."""
    gate = _gelu_tanh(x @ p.w_gate_branch)
    xproj = x @ p.w_x_branch
    a, b = _gates(p, _causal_conv(xproj, p.conv_w, p.conv_b))
    h = linear_scan(a, b).to(x.dtype)
    out = (gate * h) @ p.w_out
    return out, {"h": h[:, -1].float().clone(), "conv": conv_state(xproj, cfg.conv_width)}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    w = cfg.rnn_width_
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device)}


def apply_rglru_step(p: RGLRU, x: torch.Tensor, state: dict, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One token: x (B, 1, d); ``state`` is updated in place and returned."""
    gate = _gelu_tanh(x @ p.w_gate_branch)                       # (B, 1, w)
    window = torch.cat([state["conv"], x @ p.w_x_branch], dim=1)  # (B, cw, w), oldest first
    # the sequence conv applies conv_w[0] to the newest tap
    xb = torch.einsum("bcw,cw->bw", window, p.conv_w.flip(0)) + p.conv_b
    a, b = _gates(p, xb)
    h = a * state["h"] + b
    out = (gate[:, 0] * h.to(x.dtype)) @ p.w_out
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return out[:, None, :], state
