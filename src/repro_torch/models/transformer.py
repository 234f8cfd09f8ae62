"""Decoder backbone: train, prefill and decode.

The counterpart of ``repro/models/transformer.py``.  A model is the
config's ``pattern`` of block kinds cycled over ``n_layers``: "global" and
"local" attention, "rglru" (``models/rglru.py``, recurrentgemma) and
"mamba2" (``models/mamba2.py``); a :class:`Transformer` module stacks one
:class:`Block` per layer, walked by a Python loop.  Layer ``l`` holds what
the reference keeps at ``groups[l % len(pattern)][l // len(pattern)]`` (its
stacked cycles), and the remainder (``tail``) comes after
(``convert.lm_params_from_numpy``).

Three entry modes, as the reference's:

  * train: the full sequence, no caches; each block runs under
    ``torch.utils.checkpoint`` (recomputed in the backward, the port's form
    of the reference's ``jax.checkpoint`` of a cycle), and :func:`loss_fn`
    takes the mean next-token cross entropy, vocab-chunked;
  * prefill: the full sequence, last-position logits and the decode caches;
  * step: one token against the caches, updated in place.

Every attention layer of train and prefill runs the flash kernel forward;
the recurrent kinds and the mixture-of-experts feed-forward
(``models/moe.py``, in place of the MLP of an attention block when
``cfg.n_experts`` is set) run plain torch (the reference has no kernel
there).

The inputs are (B, S) token ids, or, for the embeddings input of the
modality stubs (llava, musicgen: ``cfg.input_mode == "embeddings"``),
(B, S, d) float embeddings, cast to the activation type; both then take
``embed_scale`` and the sinusoids.  Decode takes token ids through
``embed`` in either mode, as the reference's ``decode_fn``.

A layer's decode cache is ``{"k", "v"}`` on an attention layer and the
recurrent state ``{"h", "conv"}`` on an rglru or mamba2 one.  The attention
caches follow ``attention.cache_shape``: ``min(window,
cache_len)`` slots on a local layer, ``cache_len`` on a global one, with
``cache_len`` = S + 1 by default.  (The reference's prefill sizes a local
ring ``min(window, S)`` and a global one S + 1 whatever the caller needs,
so its first decoded token overwrites position 0 when S < window, and its
second one on a global layer; ROADMAP.md §3.)
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models.layers import (
    MLP,
    Norm,
    _param,
    apply_mlp,
    apply_norm,
    as_generator,
    init_mlp_,
    init_param_,
    rounded,
    sinusoidal_pos_emb,
    softcap,
)

def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer kind the reference does not have."""
    for kind in set(cfg.layer_kinds()):
        if kind not in ("global", "local", "rglru", "mamba2"):
            raise ValueError(kind)


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """norm1 -> mixer -> (post_norm1) -> residual; norm2 -> feed-forward -> (post_norm2) -> residual.

    The mixer is ``attn`` (global, local), ``rec`` (rglru) or ``ssm``
    (mamba2); a mamba2 block has no feed-forward, as the reference's.  The
    feed-forward is ``mlp``, or ``moe`` on an attention block when
    ``cfg.n_experts`` is set.
    """

    def __init__(self, kind: str, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.has_ffn = kind != "mamba2" and cfg.d_ff > 0
        self.norm1 = Norm(cfg.norm, d, dtype, device)
        if kind == "rglru":
            self.rec = rg.RGLRU(cfg, dtype, device)
        elif kind == "mamba2":
            self.ssm = m2.Mamba2(cfg, dtype, device)
        else:
            self.attn = attn.Attention(cfg, dtype, device)
        if self.has_ffn:
            self.norm2 = Norm(cfg.norm, d, dtype, device)
            if cfg.n_experts and kind in ("global", "local"):
                self.moe = moe_mod.MoE(cfg, dtype, device)
            else:
                self.mlp = MLP(cfg.mlp, d, cfg.d_ff, dtype, device)
        if cfg.post_norm:
            self.post_norm1 = Norm(cfg.norm, d, dtype, device)
            if self.has_ffn:
                self.post_norm2 = Norm(cfg.norm, d, dtype, device)


class Transformer(nn.Module):
    """``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V) when untied, and one Block per layer.

    Parameters are allocated in ``cfg.param_dtype`` and left unset; they are
    drawn by :func:`init_model` or copied by ``convert.lm_params_from_numpy``.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        dtype = _dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), dtype, device)
        self.layers = nn.ModuleList(Block(kind, cfg, dtype, device) for kind in cfg.layer_kinds())


def _init_block_(blk: Block, generator: torch.Generator) -> Block:
    if blk.kind == "rglru":
        rg.init_rglru_(blk.rec, generator)
    elif blk.kind == "mamba2":
        m2.init_mamba2_(blk.ssm, generator)
    else:
        attn.init_attention_(blk.attn, generator)
    if hasattr(blk, "mlp"):
        init_mlp_(blk.mlp, generator)
    if hasattr(blk, "moe"):
        moe_mod.init_moe_(blk.moe, generator)
    return blk


def init_model(cfg: ModelConfig, generator: Union[torch.Generator, int] = 0, device="cuda") -> Transformer:
    """Random weights at the reference's scales (truncated normals), in ``cfg.param_dtype``.

    ``generator`` is a ``torch.Generator`` (on ``device``: the weights are
    drawn there) or an int seed.  Norm scales and biases start as the
    reference's (zeros, or ones for a layernorm scale).
    """
    dev = resolve_device(device)
    gen = as_generator(generator, dev)
    model = Transformer(cfg, dev)
    s = 1.0 / math.sqrt(cfg.d_model)
    init_param_(model.embed, gen, s)
    if not cfg.tie_embeddings:
        init_param_(model.lm_head, gen, s)
    for blk in model.layers:
        _init_block_(blk, gen)
    return model


def _block_cache_template(kind: str, cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    if kind == "rglru":
        return rg.init_rglru_state(cfg, batch, dtype, device)
    if kind == "mamba2":
        return m2.init_mamba2_state(cfg, batch, dtype, device)
    return attn.init_cache(cfg, batch, max_len, kind == "local", dtype, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> List[dict]:
    """Empty decode caches, one a layer (``{"k", "v"}`` or ``{"h", "conv"}``); the recurrent ``h`` float32, the
    rest in the activation type."""
    dev = resolve_device(device)
    dtype = _dtype(cfg.activation_dtype)
    return [_block_cache_template(kind, cfg, batch, max_len, dtype, dev) for kind in cfg.layer_kinds()]


# ---------------------------------------------------------------------------
# Blocks and the backbone.
# ---------------------------------------------------------------------------


def _kv_to_ring(kv, cfg: ModelConfig, local: bool, cache_len: Optional[int] = None) -> dict:
    """Prefill (k, v) of shape (B, S, KV, hd) -> decode cache sized by ``attention.cache_shape``.

    ``cache_len`` is the longest sequence the cache must serve (default
    S + 1: one decoded token); a local layer keeps ``min(window,
    cache_len)`` slots, a global one ``cache_len``.  Position p sits in
    slot p % slots.
    """
    k, v = kv
    b, s = k.shape[:2]
    cache_len = s + 1 if cache_len is None else cache_len
    if cache_len <= s:
        raise ValueError(f"cache_len {cache_len} must exceed the prompt length {s}")
    w = attn.cache_shape(cfg, b, cache_len, local)[1]
    keep = min(w, s)
    idx = torch.arange(s - keep, s, device=k.device) % w
    ck = torch.zeros((b, w) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device)
    cv = torch.zeros_like(ck)
    ck.index_copy_(1, idx, k[:, s - keep:])
    cv.index_copy_(1, idx, v[:, s - keep:])
    return {"k": ck, "v": cv}


def apply_block(
    p: Block,
    kind: str,
    x: torch.Tensor,
    positions,
    cfg: ModelConfig,
    *,
    mode: str,
    cache=None,
    pos=None,
    cache_len: Optional[int] = None,
):
    """Returns (x, cache): the prefill's new cache, the step's cache updated in place, or None in train mode."""
    if mode not in ("train", "prefill", "step"):
        raise ValueError(f"mode {mode!r}: one of train, prefill, step")
    h = apply_norm(p.norm1, x, cfg.norm)
    if kind in ("rglru", "mamba2"):
        mod, seq, step = ((p.rec, rg.apply_rglru_seq, rg.apply_rglru_step) if kind == "rglru"
                          else (p.ssm, m2.apply_mamba2_seq, m2.apply_mamba2_step))
        if mode == "step":
            h, new_cache = step(mod, h, cache, cfg)
        else:
            h, state = seq(mod, h, cfg)
            new_cache = state if mode == "prefill" else None
    elif mode == "step":
        h, new_cache = attn.attend_decode(p.attn, h, pos, cache, cfg, local=kind == "local")
    else:
        h, kv = attn.attend_full(p.attn, h, positions, cfg, local=kind == "local", mode=mode)
        new_cache = None if mode == "train" else _kv_to_ring(kv, cfg, kind == "local", cache_len)
    if cfg.post_norm:
        h = apply_norm(p.post_norm1, h, cfg.norm)
    x = x + h
    if p.has_ffn:
        h = apply_norm(p.norm2, x, cfg.norm)
        h = moe_mod.apply_moe(p.moe, h, cfg) if hasattr(p, "moe") else apply_mlp(p.mlp, h, cfg.mlp)
        if cfg.post_norm:
            h = apply_norm(p.post_norm2, h, cfg.norm)
        x = x + h
    return x, new_cache


def _embed_in(params: Transformer, cfg: ModelConfig, inputs: torch.Tensor, positions):
    dtype = _dtype(cfg.activation_dtype)
    if inputs.is_floating_point():
        x = inputs.to(dtype)  # the modality stubs' (B, S, d) embeddings
    else:
        x = params.embed[inputs].to(dtype)
    if cfg.embed_scale:
        x = x * rounded(math.sqrt(cfg.d_model), dtype)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos_emb(positions, cfg.d_model).to(dtype)
    return x


def _backbone(params: Transformer, cfg: ModelConfig, x, positions, *, mode, caches=None, pos=None,
              cache_len=None):
    """The layers in order; prefill returns new caches, a step the given ones, updated in place, train None.

    In train mode each block runs under ``checkpoint`` (non-reentrant): the
    backward keeps its input and recomputes the rest, flash launch included.
    """
    new_caches = []
    for l, (kind, blk) in enumerate(zip(cfg.layer_kinds(), params.layers)):
        if mode == "train":
            def block(x, blk=blk, kind=kind):
                return apply_block(blk, kind, x, positions, cfg, mode="train")[0]

            x = checkpoint(block, x, use_reentrant=False)
            continue
        x, c = apply_block(blk, kind, x, positions, cfg, mode=mode,
                           cache=None if caches is None else caches[l], pos=pos, cache_len=cache_len)
        new_caches.append(c)
    x = apply_norm(params.final_norm, x, cfg.norm)
    if mode == "train":
        return x, None
    return x, new_caches if caches is None else caches


def _logits(params: Transformer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params.embed.to(x.dtype).T
    else:
        logits = x @ params.lm_head.to(x.dtype)
    return softcap(logits, cfg.final_softcap)


def loss_fn(params: Transformer, cfg: ModelConfig, inputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (float32 scalar), vocab-chunked over the sequence.

    The reference's arithmetic: each chunk of ``loss_chunk`` positions
    (when it divides S; else the whole sequence) takes its logits in the
    activation type with the final softcap, then float32, and sums
    ``logsumexp - gold``; the chunk is recomputed in the backward
    (``checkpoint``), so that the peak holds one chunk's logits.  The gold
    logit is a gather: the reference contracts a one-hot only to keep the
    vocab dim sharded under GSPMD, and its value is the same.  ``inputs``
    are (B, S) token ids or (B, S, d) embeddings, ``labels`` (B, S) ids.
    """
    b, s = labels.shape
    positions = torch.arange(s, device=inputs.device)[None, :].expand(b, s)
    x = _embed_in(params, cfg, inputs, positions)
    x, _ = _backbone(params, cfg, x, positions, mode="train")
    return loss_head(params, cfg, x, labels)


def loss_head(params: Transformer, cfg: ModelConfig, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`loss_fn` after the backbone: the mean cross entropy of the final-normed x (B, S, d), chunked."""
    b, s = labels.shape
    c = cfg.loss_chunk if cfg.loss_chunk and s % cfg.loss_chunk == 0 else s

    def chunk_ce(xx, ll):
        logits = _logits(params, cfg, xx).float()
        gold = torch.gather(logits, -1, ll[..., None])[..., 0]
        return torch.sum(torch.logsumexp(logits, dim=-1) - gold)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + checkpoint(chunk_ce, x[:, i:i + c], labels[:, i:i + c].long(), use_reentrant=False)
    return total / (b * s)


def prefill_fn(params: Transformer, cfg: ModelConfig, inputs: torch.Tensor, cache_len: Optional[int] = None):
    """Full-sequence forward: (last-position logits (B, V), decode caches).

    ``inputs`` (B, S) token ids or (B, S, d) embeddings.  The caches serve positions up to
    ``cache_len`` - 1 (default S, one decoded token).
    """
    b, s = inputs.shape[0], inputs.shape[1]
    positions = torch.arange(s, device=inputs.device)[None, :].expand(b, s)
    x = _embed_in(params, cfg, inputs, positions)
    x, caches = _backbone(params, cfg, x, positions, mode="prefill", cache_len=cache_len)
    return _logits(params, cfg, x[:, -1]), caches


def decode_fn(params: Transformer, cfg: ModelConfig, token: torch.Tensor, pos, caches: List[dict]):
    """One decode step: token (B, 1) ids at position ``pos``; the caches are updated in place."""
    pos = int(pos)
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=token.device)
    x = _embed_in(params, cfg, token, positions)
    x, caches = _backbone(params, cfg, x, positions, mode="step", caches=caches, pos=pos)
    return _logits(params, cfg, x[:, 0]), caches


def from_tensors(cfg: ModelConfig, tensors) -> Transformer:
    """A :class:`Transformer` whose parameters are the given tensors (name -> tensor, every parameter), not copied."""
    model = Transformer(cfg, device="meta")
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(tensors):
        raise ValueError(f"parameter trees differ: missing {sorted(set(names) - set(tensors))}, "
                         f"unexpected {sorted(set(tensors) - set(names))}")
    for name in names:
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(tensors[name], requires_grad=False))
    return model
