"""Attention: MHA/GQA/MQA, global and sliding-window, softcap, decode.

The counterpart of ``repro/models/attention.py`` for the serving path:

  * grouped-query attention (n_kv_heads < n_heads), MQA and MHA;
  * global (causal) and local (sliding-window) masks;
  * the attention-logit softcap (gemma2);
  * QKV biases (qwen1.5, chatglm3), q/k head RMS norm (qwen3), partial
    RoPE (chatglm3);
  * single-token decode against a KV cache, a ring of ``window`` slots on
    local layers.

Prefill and training attention (:func:`attend_full`) run the hand-written
flash kernel (``ops.flash_attention``) forward, which never holds the
(S, T) scores.  Its backward is autograd of the reference's own arithmetic
(:func:`_scores_softmax_out` under the causal mask), query-chunked by
``attn_chunk`` as the reference's ``_attend_chunked`` with each chunk
recomputed in the backward, so that its peak is one chunk's scores
(:func:`attention_ref`); the reference has no backward kernel.  Decode
attention (:func:`attend_decode`) keeps the reference's arithmetic in plain
torch: scores in the activation type, a float32 denominator.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Norm, _param, apply_norm, apply_rope, init_param_, rounded, softcap

NEG_INF = -(2.0**30)


class Attention(nn.Module):
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d); optional biases and q/k norms."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.wq = _param((d, h, hd), dtype, device)
        self.wk = _param((d, kv, hd), dtype, device)
        self.wv = _param((d, kv, hd), dtype, device)
        self.wo = _param((h, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((h, hd), dtype, device, 0.0)
            self.bk = _param((kv, hd), dtype, device, 0.0)
            self.bv = _param((kv, hd), dtype, device, 0.0)
        if cfg.qk_norm:
            self.q_norm = Norm("rmsnorm", hd, dtype, device)
            self.k_norm = Norm("rmsnorm", hd, dtype, device)


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype, device=None) -> Attention:
    return init_attention_(Attention(cfg, dtype, device), generator)


def init_attention_(p: Attention, generator: torch.Generator) -> Attention:
    """Draw the projections in place: 1/sqrt(d) into q, k, v, 1/sqrt(H hd) out."""
    d, h, hd = p.wq.shape
    for w in (p.wq, p.wk, p.wv):
        init_param_(w, generator, 1.0 / math.sqrt(d))
    init_param_(p.wo, generator, 1.0 / math.sqrt(h * hd))
    return p


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.qk_norm:
        q = apply_norm(p.q_norm, q, "rmsnorm")
        k = apply_norm(p.k_norm, k, "rmsnorm")
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        k = apply_rope(k, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    return q, k, v


def _scores_softmax_out(q, k, v, mask, cfg: ModelConfig):
    """q (B,Sq,H,hd), k/v (B,T,KV,hd), mask (B,Sq,T) bool -> (B,Sq,H,hd).

    The reference's arithmetic: scores in the activation type, the softmax's
    max and exp in that type, its denominator summed in float32.
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) * rounded(1.0 / math.sqrt(hd), q.dtype)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)  # -2^30: exact in bf16
    mx = torch.amax(scores, dim=-1, keepdim=True).detach()  # the reference's stop_gradient
    ex = torch.exp(scores - mx)
    denom = torch.sum(ex, dim=-1, keepdim=True, dtype=torch.float32)
    probs = ex * (1.0 / denom).to(ex.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, sq, h, hd)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int]):
    """(B,Sq),(B,T) position ids -> (B,Sq,T) bool mask."""
    m = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        m &= k_pos[:, None, :] > q_pos[:, :, None] - window
    return m


def attention_ref(q, k, v, positions: torch.Tensor, cfg: ModelConfig, window: Optional[int]) -> torch.Tensor:
    """The reference's training attention: :func:`_scores_softmax_out` under the causal mask.

    With ``attn_chunk`` (dividing S, shorter than S) the queries go in
    chunks, each recomputed in the backward (``checkpoint``), as the
    reference's ``_attend_chunked`` under ``jax.checkpoint``: the backward
    holds one chunk's scores, (B, KV, H/KV, chunk, T), at a time.
    """
    s = q.shape[1]
    c = cfg.attn_chunk
    if not c or s <= c:
        return _scores_softmax_out(q, k, v, _causal_mask(positions, positions, window), cfg)
    if s % c:
        raise ValueError(f"seq {s} must divide attn_chunk {c}")

    def chunk(qi, pi, k, v):
        return _scores_softmax_out(qi, k, v, _causal_mask(pi, positions, window), cfg)

    outs = [checkpoint(chunk, q[:, i:i + c], positions[:, i:i + c], k, v, use_reentrant=False)
            for i in range(0, s, c)]
    return torch.cat(outs, dim=1)


def attend_full(
    p: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    local: bool,
    mode: str = "prefill",
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Prefill or training attention over the full sequence, through the flash kernel.

    ``positions`` are 0..S-1 in every row (as prefill and training pass
    them): the kernel masks by index, ``col <= row`` and, on a local layer,
    ``col > row - window``.  Under grad the backward differentiates
    :func:`attention_ref`.  Returns (output, (k, v)) in prefill mode, so
    that prefill can seed the decode cache, and (output, None) in train mode.
    """
    q, k, v = _project_qkv(p, x, positions, cfg)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    window = cfg.window if local else None
    ref = functools.partial(attention_ref, positions=positions, cfg=cfg, window=window)
    out = ops.flash_attention(q, k, v, causal=True, softcap=cfg.attn_softcap, window=window, ref=ref)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return y, (None if mode == "train" else (k, v))


# ---------------------------------------------------------------------------
# Decode (single token, KV cache).  Local layers use a ring buffer of window
# slots; global layers a full-length cache.
# ---------------------------------------------------------------------------


def cache_shape(cfg: ModelConfig, batch: int, max_len: int, local: bool):
    w = min(cfg.window, max_len) if local else max_len
    return (batch, w, cfg.n_kv_heads, cfg.head_dim_)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, local: bool, dtype, device=None):
    shp = cache_shape(cfg, batch, max_len, local)
    return {"k": torch.zeros(shp, dtype=dtype, device=device), "v": torch.zeros(shp, dtype=dtype, device=device)}


def attend_decode(
    p: Attention,
    x: torch.Tensor,         # (B, 1, d)
    pos: int,                # current position
    cache: dict,
    cfg: ModelConfig,
    *,
    local: bool,
) -> Tuple[torch.Tensor, dict]:
    """One token against the cache; the cache is updated in place and returned."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, positions, cfg)
    w = cache["k"].shape[1]
    slot = pos % w
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    # position held by ring slot t:  largest p' <= pos with p' % w == t
    t = torch.arange(w, device=x.device)
    k_pos = pos - (pos - t) % w
    valid = (k_pos >= 0) & (k_pos <= pos)
    if local:
        valid &= k_pos > pos - cfg.window
    mask = valid[None, None, :].expand(b, 1, w)
    out = _scores_softmax_out(q, cache["k"], cache["v"], mask, cfg)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return y, cache
