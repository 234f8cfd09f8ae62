"""Serving step factories: prefill and decode, mesh-aware.

The counterpart of ``repro/train/serve_step.py``: each factory returns
``(fn, shardings)``.  ``make_prefill_step(cfg)`` gives
``prefill(params, inputs, cache_len=None)``: the full-context forward, the
last token's logits and the decode caches (every attention layer through
the flash kernel).  ``make_decode_step(cfg)`` gives
``decode(params, token, pos, caches)``: one token for every sequence of the
batch against the caches, which it updates in place (the port's
counterpart of ``donate_argnums``; ``donate_cache=False`` works on a copy
and leaves them as they were).  Both run under ``torch.no_grad()``.

Under a ``mesh`` (SPMD: every rank calls with the same global inputs)
``params`` holds this rank's blocks (``shardings["params"]``, the rules of
``dist.sharding``), gathered before use; the inputs ((B, S) tokens or
(B, S, d) embeddings, ``input_shardings``) and the decoded tokens are cut
to the rank's rows of the batch (``batch_spec``), the caches hold the
rank's rows (``cache_shardings``), and the logits are gathered at the
output, so that every rank returns the global (B, V) logits.  A
mixture-of-experts layer routes the rank's rows as parts of the global
batch's groups (``moe.routing_over``).  ``shape`` (the global batch; the
decode caches' length) is required there.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.tree import map_tree


def _layout(cfg: ModelConfig, mesh, shape: Optional[ShapeConfig], who: str):
    if shape is None:
        raise ValueError(f"{who}: a sharded step needs shape= (its global batch)")
    p_sh = shard_rules.param_shardings(tf.Transformer(cfg, device="meta"), mesh)
    rows = shard_rules.Sharding(mesh, shard_rules.batch_spec(mesh, shape.global_batch, None))
    return p_sh, rows


def make_prefill_step(cfg: ModelConfig, mesh=None, shape: Optional[ShapeConfig] = None):
    coll.check_mesh(mesh, "make_prefill_step")
    if mesh is None:
        @torch.no_grad()
        def prefill(params, inputs, cache_len=None):
            return tf.prefill_fn(params, cfg, inputs, cache_len)

        return prefill, None

    p_sh, rows = _layout(cfg, mesh, shape, "make_prefill_step")
    in_sh = shard_rules.input_shardings(cfg, shape, mesh)[0]

    @torch.no_grad()
    def prefill_sharded(params, inputs, cache_len=None):
        model = tf.from_tensors(cfg, shard_rules.collect(params, p_sh))
        with moe.routing_over(mesh, shard_rules.spec_axes(rows.spec[0])):
            logits, caches = tf.prefill_fn(model, cfg, in_sh.block(inputs), cache_len)
        return rows.gather(logits), caches

    return prefill_sharded, {"params": p_sh, "inputs": in_sh}


def make_decode_step(cfg: ModelConfig, mesh=None, shape: Optional[ShapeConfig] = None, donate_cache: bool = True):
    coll.check_mesh(mesh, "make_decode_step")

    def own(caches):
        return caches if donate_cache else map_tree(torch.clone, caches)

    if mesh is None:
        @torch.no_grad()
        def decode(params, token, pos, caches):
            return tf.decode_fn(params, cfg, token, pos, own(caches))

        return decode, None

    p_sh, rows = _layout(cfg, mesh, shape, "make_decode_step")
    c_sh = shard_rules.cache_shardings(
        cfg, shape.global_batch, mesh, tf.init_caches(cfg, shape.global_batch, shape.seq_len, device="meta"))

    @torch.no_grad()
    def decode_sharded(params, token, pos, caches):
        model = tf.from_tensors(cfg, shard_rules.collect(params, p_sh))
        with moe.routing_over(mesh, shard_rules.spec_axes(rows.spec[0])):
            logits, caches = tf.decode_fn(model, cfg, rows.block(token), pos, own(caches))
        return rows.gather(logits), caches

    return decode_sharded, {"params": p_sh, "token": rows, "caches": c_sh}
