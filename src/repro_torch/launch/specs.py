"""Meta-tensor stand-ins and probe programs for the dry-run.

The counterpart of the JAX package's ``launch/specs.py``.  Its
``ShapeDtypeStruct`` stand-ins become tensors on torch's ``meta`` device:
they carry a shape and a type and hold no data, so a step run on them
allocates nothing (:func:`params_shape`, :func:`caches_shape`,
:func:`input_specs`).

The probes (:func:`cycle_probe`, :func:`head_probe`,
:func:`optimizer_probe`) return ``(fn, args, shardings, trips)`` as the
reference's do.  In the port's SPMD form ``fn`` is what one rank runs of
that part of the sharded step: it gathers the part's parameters from the
rank's blocks (``args``, laid out by ``shardings``), takes the rank's rows
of the global batch, computes (a train cycle recomputes each block in the
backward, as the step's ``checkpoint`` does) and averages the gradients
over the data-parallel axes.  The reference needs the probes because XLA
counts a loop body once; eager torch counts every layer of the full step,
so in the port they are the step's breakdown by part (a cycle × its trips,
the head, the optimizer), not a correction of it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train.train_step import sharded_update

META = torch.device("meta")


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.activation_dtype]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def params_shape(cfg: ModelConfig) -> tf.Transformer:
    """The model with every parameter on the meta device."""
    return tf.Transformer(cfg, device=META)


def caches_shape(cfg: ModelConfig, batch: int, max_len: int):
    """Decode caches of ``batch`` sequences up to ``max_len`` tokens, on the meta device."""
    return tf.init_caches(cfg, batch, max_len, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, object]:
    """The model inputs of one (arch × shape) cell, as meta tensors of the reference's shapes and types."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.input_mode == "embeddings":
            inputs = _meta((b, s, cfg.d_model), _act_dtype(cfg))
        else:
            inputs = _meta((b, s), torch.int32)
        return {"inputs": inputs, "labels": _meta((b, s), torch.int32)}
    if shape.kind == "prefill":
        if cfg.input_mode == "embeddings":
            return {"inputs": _meta((b, s, cfg.d_model), _act_dtype(cfg))}
        return {"inputs": _meta((b, s), torch.int32)}
    if shape.kind == "decode":
        return {"token": _meta((b, 1), torch.int32), "pos": _meta((), torch.int32), "caches": caches_shape(cfg, b, s)}
    raise ValueError(shape.kind)


def rank_blocks(named: Dict[str, torch.Tensor], shardings) -> Dict[str, torch.Tensor]:
    """Meta tensors of this rank's block of each named tensor under ``shardings``."""
    return {n: _meta(shardings[n].block_shape(t.shape), t.dtype) for n, t in named.items()}


def _with_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor], grad: bool) -> nn.Module:
    """``module`` with its parameters replaced by ``tensors`` (name -> tensor, every parameter), not copied."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner) if owner else module, leaf, nn.Parameter(t, requires_grad=grad))
    return module


def _dp(mesh, batch: int):
    return shard_rules.spec_axes(shard_rules.batch_spec(mesh, batch)[0])


def _mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return coll.psum(x, mesh, axes) / coll.axes_size(mesh, axes) if axes else x


def _layout(cfg: ModelConfig, mesh):
    model = params_shape(cfg)
    return model, shard_rules.param_shardings(model, mesh)


def _cycle_parts(cfg: ModelConfig, mesh):
    """(per block of one pattern cycle: its parameter shardings and this rank's meta blocks)."""
    model, p_sh = _layout(cfg, mesh)
    named = dict(model.named_parameters())
    sh, blocks = [], []
    for i in range(len(cfg.pattern)):
        prefix = f"layers.{i}."
        own = {n[len(prefix):]: t for n, t in named.items() if n.startswith(prefix)}
        own_sh = {n[len(prefix):]: p_sh[n] for n in named if n.startswith(prefix)}
        sh.append(own_sh)
        blocks.append(rank_blocks(own, own_sh))
    return sh, blocks


def cycle_probe(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """One pattern cycle as a rank runs it: forward (serving), forward and backward (train), or one decode step
    against a cycle's cache slice.  Returns (fn, args, shardings, trips)."""
    b, s = shape.global_batch, shape.seq_len
    dt = _act_dtype(cfg)
    sh, blocks = _cycle_parts(cfg, mesh)
    trips = cfg.n_layers / len(cfg.pattern)
    rows = shard_rules.Sharding(mesh, shard_rules.batch_spec(mesh, b, None, None))
    dp = _dp(mesh, b)
    dtype = tf._dtype(cfg.param_dtype)

    def modules(cycle_blocks, grad):
        return [_with_tensors(tf.Block(kind, cfg, dtype, META), shard_rules.collect(blk, bsh), grad)
                for kind, blk, bsh in zip(cfg.pattern, cycle_blocks, sh)]

    if shape.kind in ("train", "prefill"):
        pos_rows = shard_rules.Sharding(mesh, shard_rules.batch_spec(mesh, b, None))

        def fwd(mods, x, positions, mode):
            for kind, blk in zip(cfg.pattern, mods):
                if mode == "train":
                    x = checkpoint(lambda y, blk=blk, kind=kind: tf.apply_block(blk, kind, y, positions, cfg,
                                                                                 mode="train")[0],
                                   x, use_reentrant=False)
                else:
                    x, _ = tf.apply_block(blk, kind, x, positions, cfg, mode=mode)
            return x

        if shape.kind == "train":
            def fn(cycle_blocks, x, positions):
                mods = modules(cycle_blocks, grad=True)
                params = [p for m in mods for p in m.parameters()]
                with moe.routing_over(mesh, dp), torch.enable_grad():
                    xr = rows.block(x).requires_grad_(True)
                    loss = torch.sum(fwd(mods, xr, pos_rows.block(positions), "train").float() ** 2)
                    grads = torch.autograd.grad(loss, params + [xr])
                return [_mean_over(g, mesh, dp) for g in grads[:-1]] + [grads[-1]]
        else:
            @torch.no_grad()
            def fn(cycle_blocks, x, positions):
                mods = modules(cycle_blocks, grad=False)
                with moe.routing_over(mesh, dp):
                    return fwd(mods, rows.block(x), pos_rows.block(positions), "prefill")

        args = (blocks, _meta((b, s, cfg.d_model), dt), _meta((b, s), torch.int64))
        return fn, args, (sh, rows, pos_rows), trips

    # decode: one step of a cycle against the rank's rows of a cycle's caches
    full = caches_shape(cfg, b, s)[:len(cfg.pattern)]
    c_sh = shard_rules.cache_shardings(cfg, b, mesh, full)
    cache_slice = [rank_blocks(c, cs) for c, cs in zip(full, c_sh)]

    @torch.no_grad()
    def fn(cycle_blocks, x, pos, cache):
        mods = modules(cycle_blocks, grad=False)
        xr = rows.block(x)
        positions = torch.full((xr.shape[0], 1), pos, dtype=torch.int64, device=xr.device)
        with moe.routing_over(mesh, dp):
            for i, (kind, blk) in enumerate(zip(cfg.pattern, mods)):
                xr, cache[i] = tf.apply_block(blk, kind, xr, positions, cfg, mode="step", cache=cache[i], pos=pos)
        return xr, cache

    args = (blocks, _meta((b, 1, cfg.d_model), dt), s - 1, cache_slice)
    return fn, args, (sh, rows, None, c_sh), trips


def head_probe(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The output head as a rank runs it: the cross entropy over the vocabulary and its backward (train), or the
    logits of the last position (serving), gathered over the batch.  Returns (fn, args, shardings, 1.0)."""
    b, s = shape.global_batch, shape.seq_len
    dt = _act_dtype(cfg)
    model, p_sh = _layout(cfg, mesh)
    names = ["embed"] + ([] if cfg.tie_embeddings else ["lm_head"])
    named = dict(model.named_parameters())
    hp_sh = {n: p_sh[n] for n in names}
    hp = rank_blocks({n: named[n] for n in names}, hp_sh)
    dp = _dp(mesh, b)

    def head(blocks, grad):
        full = shard_rules.collect(blocks, hp_sh)
        return SimpleNamespace(**{n: t.requires_grad_(grad) for n, t in full.items()})

    if shape.kind == "train":
        rows = shard_rules.Sharding(mesh, shard_rules.batch_spec(mesh, b, None, None))
        lab_rows = shard_rules.Sharding(mesh, shard_rules.batch_spec(mesh, b, None))

        def fn(blocks, x, labels):
            h = head(blocks, grad=True)
            leaves = [getattr(h, n) for n in names]
            with torch.enable_grad():
                xr = rows.block(x).requires_grad_(True)
                loss = tf.loss_head(h, cfg, xr, lab_rows.block(labels).long())
                grads = torch.autograd.grad(loss, leaves + [xr], allow_unused=True)
            # an untied head leaves the embedding unused: its gradient is zeros, as the step's
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves + [xr], grads)]
            return _mean_over(loss.detach(), mesh, dp), [_mean_over(g, mesh, dp) for g in grads[:-1]] + [grads[-1]]

        args = (hp, _meta((b, s, cfg.d_model), dt), _meta((b, s), torch.int32))
        return fn, args, (hp_sh, rows, lab_rows), 1.0

    rows = shard_rules.Sharding(mesh, shard_rules.batch_spec(mesh, b, None))

    @torch.no_grad()
    def fn(blocks, x):
        return rows.gather(tf._logits(head(blocks, grad=False), cfg, rows.block(x)))

    return fn, (hp, _meta((b, cfg.d_model), dt)), (hp_sh, rows), 1.0


def optimizer_probe(cfg: ModelConfig, optimizer, mesh):
    """The sharded step's update on the full averaged gradients.  Returns (fn, args, shardings, 1.0)."""
    model, p_sh = _layout(cfg, mesh)
    named = dict(model.named_parameters())
    state = optimizer.init(model)
    o_sh = shard_rules.opt_state_shardings(state, model, mesh)

    def fn(grads, opt_state, params):
        return sharded_update(optimizer, grads, opt_state, params, p_sh, o_sh)

    grads = {n: _meta(t.shape, t.dtype) for n, t in named.items()}
    args = (grads, shard_rules.distribute(state, o_sh), rank_blocks(named, p_sh))
    return fn, args, (p_sh, o_sh, p_sh), 1.0
