"""Serving step factories: prefill and decode.

``make_prefill_step(cfg)`` returns ``prefill(params, inputs, cache_len=None)``:
the full-context forward, giving last-token logits and the decode caches
(every attention layer through the flash kernel).  ``make_decode_step(cfg)``
returns ``decode(params, token, pos, caches)``: one token for every
sequence of the batch against the caches, which it updates in place (the
port's counterpart of the reference's ``donate_argnums``).  PyTorch runs
eagerly, so nothing is compiled; both run under ``torch.no_grad()``.
Meshes (the reference's ``mesh=``) are ROADMAP.md queue 1 step 10b.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("sharded language-model serving is not ported (ROADMAP.md queue 1, step 10b)")


def make_prefill_step(cfg: ModelConfig, mesh=None):
    _no_mesh(mesh)

    @torch.no_grad()
    def prefill(params, inputs, cache_len=None):
        return tf.prefill_fn(params, cfg, inputs, cache_len)

    return prefill


def make_decode_step(cfg: ModelConfig, mesh=None):
    _no_mesh(mesh)

    @torch.no_grad()
    def decode(params, token, pos, caches):
        return tf.decode_fn(params, cfg, token, pos, caches)

    return decode
