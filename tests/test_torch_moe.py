"""The port's mixture-of-experts feed-forward against the JAX package's.

``models.moe`` of the port against ``repro.models.moe``, in float32 on the
CPU, on the qwen3-moe (top-2 of 8, SwiGLU) and arctic (the same with a dense
residual) smoke configurations, with the reference's weights copied over and
inputs drawn with numpy: ``apply_moe`` within 2e-5 (float32 sums of ~1 in
another order; the measured gaps are ~1e-6), without drops (capacity factor
50) and with them (0.5); the routing tables (each choice's position, keep
and destination slot) equal to the reference's integer for integer; the
dense residual; the load-balance loss within 1e-6; the reference's
permutation property; the single-group fallback at a token count the group
size does not divide; and the gradients of a whole block with a MoE within
1e-4 max|g| + 1e-6 of ``jax.grad`` (``tests/test_torch_lm_train.py``'s rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

ATOL = 2e-5
ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")


def T(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _load(module, tree):
    """Copy a JAX parameter dict (nested) into a module's parameters of the same dotted names."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _load(getattr(module, key), val)
        else:
            getattr(module, key).data.copy_(T(val))
    return module


def _pair(arch, seed=0, **kw):
    """(JAX config, JAX MoE params, port config, port MoE holding them)."""
    jcfg, cfg = _cfgs(arch, **kw)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, p, cfg, _load(tmoe.MoE(cfg), p)


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("cf", [50.0, 0.5], ids=["no_drops", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, cf):
    """Three groups of 64 tokens; capacity factor 0.5 drops about a third of the choices."""
    jcfg, p, cfg, mod = _pair(arch, capacity_factor=cf)
    x = _x((2, 96, cfg.d_model))
    want = np.asarray(jmoe.apply_moe(p, jnp.asarray(x), jcfg))
    with tmoe.recording() as rec:
        got = tmoe.apply_moe(mod, T(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    dropped = sum(int((~r["kept"]).sum()) for r in rec)
    assert len(rec) == 1 and rec[0]["expert"].shape == (2 * 96, cfg.experts_per_token)
    assert (dropped == 0) if cf > 1 else (dropped > 0.2 * 2 * 96 * cfg.experts_per_token)


class _Spy:
    """``jax.numpy`` for ``repro.models.moe`` that keeps what the routing computes: ``stack`` gives the
    positions, the first ``where`` the keep mask (its condition) and the destinations (its value)."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def stack(self, xs, axis=0):
        out = jnp.stack(xs, axis=axis)
        self.seen.setdefault("position", np.asarray(out))
        return out

    def where(self, cond, a, b):
        out = jnp.where(cond, a, b)
        if "dest" not in self.seen:
            self.seen["keep"], self.seen["dest"] = np.asarray(cond), np.asarray(out)
        return out


@pytest.mark.parametrize("cf", [50.0, 0.5], ids=["no_drops", "drops"])
def test_routing_tables_are_the_references(monkeypatch, cf):
    """One group, eagerly through the reference's ``_route_group``: position, keep and dest integer for integer."""
    jcfg, p, cfg, mod = _pair("qwen3-moe-235b-a22b", capacity_factor=cf)
    x = _x((64, cfg.d_model), seed=2)
    spy = _Spy()
    monkeypatch.setattr(jmoe, "jnp", spy)
    jmoe._route_group(p, jnp.asarray(x), jcfg)
    _, idx, position, keep, dest = tmoe.route(mod, T(x)[None], cfg)
    assert idx.shape == position.shape == (1, 64, cfg.experts_per_token)
    np.testing.assert_array_equal(position[0].numpy(), spy.seen["position"])
    np.testing.assert_array_equal(keep[0].numpy(), spy.seen["keep"])
    np.testing.assert_array_equal(dest[0].numpy(), spy.seen["dest"])
    assert bool(keep.all()) if cf > 1 else not bool(keep.all())


def test_dense_residual_is_the_references():
    jcfg, p, cfg, mod = _pair("arctic-480b", capacity_factor=50.0)
    x = _x((1, 32, cfg.d_model), scale=0.5)
    with_res = tmoe.apply_moe(mod, T(x), cfg)
    without = tmoe.apply_moe(mod, T(x), dataclasses.replace(cfg, dense_residual=False))
    from repro.models.layers import apply_mlp

    want = np.asarray(apply_mlp(p["dense"], jnp.asarray(x), jcfg.mlp))
    np.testing.assert_allclose((with_res - without).numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(with_res.numpy(), np.asarray(jmoe.apply_moe(p, jnp.asarray(x), jcfg)), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_balance_loss_matches_jax(arch):
    jcfg, p, cfg, mod = _pair(arch)
    x = _x((2, 32, cfg.d_model), seed=3)
    want = float(jmoe.aux_load_balance_loss(p, jnp.asarray(x), jcfg))
    got = float(tmoe.aux_load_balance_loss(mod, T(x), cfg))
    assert abs(got - want) <= 1e-6  # a balanced router scores 1 (ROADMAP.md §3 item 4)


def test_routing_is_permutation_invariant_per_token():
    """Without drops a token's output does not depend on the others (the reference's property)."""
    _, _, cfg, mod = _pair("qwen3-moe-235b-a22b", capacity_factor=50.0)
    x = T(_x((1, 16, cfg.d_model), scale=0.5))
    out = tmoe.apply_moe(mod, x, cfg)[0]
    perm = torch.arange(15, -1, -1)
    np.testing.assert_allclose(tmoe.apply_moe(mod, x[:, perm], cfg)[0].numpy(), out[perm].numpy(), atol=2e-4)


@pytest.mark.parametrize("b,s", [(1, 75), (3, 25)])
def test_single_group_fallback(b, s):
    """75 tokens: the group size 64 does not divide them, so one group of 75 (capacity 40 at factor 2), with
    drops at factor 0.5."""
    jcfg, p, cfg, mod = _pair("qwen3-moe-235b-a22b", capacity_factor=0.5)
    x = _x((b, s, cfg.d_model), seed=4)
    assert tmoe.capacity(b * s, cfg) == 12 and tmoe.capacity(b * s, configs.get_smoke_config(
        "qwen3-moe-235b-a22b")) == 40
    with tmoe.recording() as rec:
        got = tmoe.apply_moe(mod, T(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmoe.apply_moe(p, jnp.asarray(x), jcfg)), atol=ATOL, rtol=0)
    assert rec[0]["expert"].shape[0] == b * s and not bool(rec[0]["kept"].all())


@pytest.mark.parametrize("arch", ARCHS)
def test_block_gradients_match_jax(arch):
    """A global-attention block whose feed-forward is the MoE, in train mode: d(sum(out · c)) for every parameter
    and the input, with drops (capacity factor 0.5)."""
    jcfg, cfg = _cfgs(arch, capacity_factor=0.5)
    jp = jtf.init_block(jax.random.PRNGKey(5), "global", jcfg, jnp.float32)
    blk = _load(ttf.Block("global", cfg), jp)
    b, s = 2, 32
    x, cot = _x((b, s, cfg.d_model), seed=6), _x((b, s, cfg.d_model), seed=7)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))

    def f(params, xx):
        return jnp.sum(jtf.apply_block(params, "global", xx, jnp.asarray(pos), jcfg, mode="train")[0] * cot)

    jg, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, jnp.asarray(x))  # eager, the block compiles op by op
    named = dict(blk.named_parameters())
    for t in named.values():
        t.requires_grad_(True)
    xt = T(x).requires_grad_(True)
    out = ttf.apply_block(blk, "global", xt, T(pos).long(), cfg, mode="train")[0]
    grads = torch.autograd.grad(torch.sum(out * T(cot)), [*named.values(), xt])

    def flat(tree, prefix=""):
        for key, val in tree.items():
            yield from flat(val, f"{prefix}{key}.") if isinstance(val, dict) else [(f"{prefix}{key}", val)]

    want = dict(flat(jg))
    want["x"] = jgx
    assert set(want) == set(named) | {"x"} and any(n.startswith("moe.w_") for n in named)
    for name, g in zip([*named, "x"], grads):
        w = T(want[name])
        assert (g - w).abs().max() <= 1e-4 * w.abs().max() + 1e-6, name
