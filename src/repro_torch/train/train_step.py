"""Train-step factories: the plain and sharded step, and a data-parallel step with compressed gradients.

The counterpart of ``repro/train/train_step.py``.  A step is
``step(params, opt_state, inputs, labels) -> (params, opt_state, loss)``:
the gradients of ``transformer.loss_fn`` by autograd (each block and each
loss chunk recomputed in the backward), then the optimizer's update, which
writes into the given parameters and states (the port's counterpart of
``donate_argnums``); ``donate=False`` works on copies and leaves them as
they were.  PyTorch runs eagerly, so nothing is compiled.

**Sharded** (``mesh=``, SPMD: every rank calls the step with the same
global batch).  ``params`` and ``opt_state`` hold this rank's block of each
leaf by ``dist.sharding``'s rules (``shardings["params"]``,
``shardings["opt"]``; ``sharding.distribute`` cuts them).  A step gathers
every parameter before use (``Sharding.gather``, one ``gather_axes`` a
leaf), runs the forward and backward on the rank's rows of the batch
(``batch_spec``; a mixture-of-experts layer routes them as parts of the
global batch's groups, ``moe.routing_over``), averages the gradients and
the loss over the DP axes (``psum``), and updates its own blocks: an
element-wise optimizer (Adam) updates the blocks in place, clipped by the
global norm of the full gradients; Adafactor, whose factored moments and RMS clip read a whole
leaf, gathers its moments, updates the full leaves and returns new
blocks.  The result equals the unsharded step's up to float32 rounding.
Ranks that share their DP coordinates but differ along ``model`` compute the
same forward and backward: that compute is replicated over ``model``, not
tensor-parallel; ``model`` divides the storage only.  While a step runs a
rank holds the full parameters and gradients.

**Compressed data parallelism** (:func:`make_compressed_dp_step`): the
parameters are replicated; each rank takes the gradients of its rows, a
mean over the DP axes other than ``compress_axis`` (``psum``) and an int8
mean with error feedback over ``compress_axis``
(``optim.compression.compressed_psum``), then the same update.  A
mixture-of-experts layer there routes each rank's rows alone, as the
reference's ``shard_map`` body does.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.optim.adam import Adam, global_norm
from repro_torch.optim.compression import compressed_psum
from repro_torch.tree import map_tree


def clone_tree(tree):
    """A copy of a tree's tensor leaves (a module is deep-copied)."""
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree)
    return map_tree(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def loss_and_grads(model: tf.Transformer, cfg: ModelConfig, inputs, labels):
    """(loss, {name: gradient}) of ``transformer.loss_fn``; the parameters' ``requires_grad`` are left as given.

    A parameter the loss does not use gets zeros, as ``jax.grad`` gives: the
    embedding table of a model fed (B, S, d) embeddings with an untied head.
    """
    named = dict(model.named_parameters())
    flags = {n: p.requires_grad for n, p in named.items()}
    try:
        for p in named.values():
            p.requires_grad_(True)
        loss = tf.loss_fn(model, cfg, inputs, labels)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    finally:
        for n, p in named.items():
            p.requires_grad_(flags[n])
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named.items(), grads)}


def _rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's contiguous share of a batch-leading tensor over ``axes`` (the whole of it with none)."""
    if not axes:
        return x
    n = coll.axes_size(mesh, axes)
    share = x.shape[0] // n
    k = coll.linear_index(mesh, axes)
    return x[k * share:(k + 1) * share]


def _mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return coll.psum(x, mesh, axes) / coll.axes_size(mesh, axes) if axes else x


def make_train_step(
    cfg: ModelConfig,
    optimizer,
    mesh=None,
    shape: Optional[ShapeConfig] = None,
    donate: bool = True,
):
    """Returns (step, shardings): ``step(params, opt_state, inputs, labels) -> (params, opt_state, loss)``.

    Without a mesh ``params`` is a :class:`~repro_torch.models.transformer.Transformer`
    and ``shardings`` None.  With one, ``shape`` (the global batch) is
    required, ``params``/``opt_state`` are this rank's blocks, and
    ``shardings`` is ``{"params", "opt", "inputs", "labels"}`` of
    :class:`~repro_torch.dist.sharding.Sharding`.
    """
    coll.check_mesh(mesh, "make_train_step")

    if mesh is None:
        def step(params, opt_state, inputs, labels):
            if not donate:
                params, opt_state = clone_tree(params), clone_tree(opt_state)
            loss, grads = loss_and_grads(params, cfg, inputs, labels)
            optimizer.update(grads, opt_state, params)
            return params, opt_state, loss

        return step, None

    if shape is None:
        raise ValueError("make_train_step: a sharded step needs shape= (its global batch)")
    meta = tf.Transformer(cfg, device="meta")
    p_sh = shard_rules.param_shardings(meta, mesh)
    o_sh = shard_rules.opt_state_shardings(optimizer.init(meta), meta, mesh)
    in_sh, lab_sh = shard_rules.input_shardings(cfg, shape, mesh)
    dp = shard_rules.spec_axes(in_sh.spec[0])

    def step(params, opt_state, inputs, labels):
        if not donate:
            params, opt_state = clone_tree(params), clone_tree(opt_state)
        full = tf.from_tensors(cfg, shard_rules.collect(params, p_sh))
        with moe.routing_over(mesh, dp):  # the backward's recomputed forward routes the same way
            loss, grads = loss_and_grads(full, cfg, in_sh.block(inputs), lab_sh.block(labels))
        grads = {n: _mean_over(g, mesh, dp) for n, g in grads.items()}
        loss = _mean_over(loss, mesh, dp)
        if isinstance(optimizer, Adam):
            full = None  # Adam updates the rank's blocks: the full parameters go first
        params, opt_state = sharded_update(optimizer, grads, opt_state, params, p_sh, o_sh, full)
        return params, opt_state, loss

    return step, {"params": p_sh, "opt": o_sh, "inputs": in_sh, "labels": lab_sh}


def sharded_update(optimizer, grads, opt_state, params, p_sh, o_sh, full=None):
    """The sharded step's update from the full, averaged ``grads``: (params, opt_state), the rank's blocks.

    Adam updates the rank's blocks in place, clipped by the full gradients'
    norm; another optimizer gathers its state and updates the full
    parameters (``full``, or gathered from ``params``) and cuts new blocks.
    """
    if isinstance(optimizer, Adam):
        norm = global_norm(grads)
        optimizer.update(shard_rules.distribute(grads, p_sh), opt_state, params, grad_norm=norm)
        return params, opt_state
    if full is None:
        full = shard_rules.collect(params, p_sh)
    full_params, full_state = optimizer.update(grads, shard_rules.collect(opt_state, o_sh), full)
    return shard_rules.distribute(full_params, p_sh), shard_rules.distribute(full_state, o_sh)


def make_compressed_dp_step(
    cfg: ModelConfig,
    optimizer,
    mesh,
    *,
    compress_axis: str = "pod",
    chunk: int = 4096,
):
    """Data-parallel step with int8 error-feedback averaging over ``compress_axis``: (step, init_err).

    ``step(params, opt_state, err, inputs, labels) -> (params, opt_state,
    err, loss)`` with the parameters replicated over the mesh (a
    ``Transformer`` on every rank) and the global batch given to every rank;
    the inputs are left as they were (the reference donates nothing here).
    ``init_err(params)`` gives float32 zeros, one a parameter.  Each
    layer's leaf is cut into its own int8 chunks; the reference cuts its
    stacked leaves, so the payloads are the same where a layer's leaf is a
    whole number of chunks.
    """
    coll.check_mesh(mesh, "make_compressed_dp_step")
    names = tuple(mesh.mesh_dim_names)
    dp_axes = tuple(a for a in shard_rules.DP_AXES if a in names)
    other_axes = tuple(a for a in dp_axes if a != compress_axis)

    def step(params, opt_state, err, inputs, labels):
        params, opt_state = clone_tree(params), clone_tree(opt_state)
        loss, grads = loss_and_grads(params, cfg, _rows(inputs, mesh, dp_axes), _rows(labels, mesh, dp_axes))
        grads = {n: _mean_over(g, mesh, other_axes) for n, g in grads.items()}
        loss = _mean_over(loss, mesh, other_axes)
        new_err = dict(err)
        if compress_axis in names:
            for n, g in grads.items():
                grads[n], new_err[n] = compressed_psum(g, err[n], mesh, compress_axis, chunk)
            loss = _mean_over(loss, mesh, (compress_axis,))
        optimizer.update(grads, opt_state, params)
        return params, opt_state, new_err, loss

    def init_err(params):
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in dict(params.named_parameters()).items()}

    return step, init_err
