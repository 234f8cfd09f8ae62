"""The port's language-model serving path against the JAX package's.

Layers, attention, and ``prefill_fn`` / ``decode_fn`` of the four dense and
the two mixture-of-experts smoke configurations, and of the two with the
embeddings input (a (B, S, d) prompt, then tokens), in float32 on the CPU
(the flash op runs its plain version), with the parameters carried over by
``convert.lm_params_from_numpy`` and the inputs drawn with numpy.  Tolerance: atol 1e-4 on activations and
logits of magnitude ~1-5, for float32 sums taken in another order (the
measured gaps are ~2e-6).

The reference's prefill caches are one slot short (ROADMAP.md §3): a local
layer's ring holds min(window, S) slots, a global layer's S + 1 whatever
the caller needs.  The port sizes them by ``attention.cache_shape``; the
last tests hold its decoded tokens against the JAX package's own full
forward where the JAX decode misses it.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
import _jax_ref
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs, convert
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.train import serve_step

ATOL = 1e-4
DENSE = ("gemma2-2b", "olmo-1b", "qwen1.5-0.5b", "chatglm3-6b")
MOE = ("qwen3-moe-235b-a22b", "arctic-480b")  # the MoE layer alone: tests/test_torch_moe.py
EMBED = ("llava-next-34b", "musicgen-large")
PORTED = DENSE + ("recurrentgemma-2b", "mamba2-1.3b") + MOE + EMBED  # the recurrent kinds: tests/test_torch_recurrent.py
# leaves that ``ModelConfig.param_count`` leaves out: norms, the RG-LRU's conv bias, Mamba-2's conv and per-head vectors
UNCOUNTED = ("norm", "rec.conv_b", "ssm.conv_w", "ssm.conv_b", "ssm.a_log", "ssm.d_skip", "ssm.dt_bias")
# the reference's forwards compiled once a shape: eager, every call compiles its ops one by one
_prefill = _jax_ref.jit(jtf.prefill_fn, static_argnums=1)
_decode = _jax_ref.jit(jtf.decode_fn, static_argnums=1)
_attend_full = _jax_ref.jit(jattn.attend_full, static_argnums=3, static_argnames="local")
_attend_decode = _jax_ref.jit(jattn.attend_decode, static_argnums=4, static_argnames="local")


def T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, np.float32)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, JAX params, port config, port model), built once."""
    out = {}
    for arch in DENSE + MOE + EMBED:
        jcfg = jconfigs.get_smoke_config(arch)
        params = jtf.init_model(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_smoke_config(arch)
        out[arch] = (jcfg, params, cfg, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu"))
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PORTED)
def test_configs_are_the_references(arch):
    assert dataclasses.asdict(configs.get_config(arch)) == dataclasses.asdict(jconfigs.get_config(arch))
    assert dataclasses.asdict(configs.get_smoke_config(arch)) == dataclasses.asdict(jconfigs.get_smoke_config(arch))


def test_arch_ids_are_the_references():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS and set(PORTED) == set(configs.ARCH_IDS)


def test_unknown_architecture_raises():
    for get in (configs.get_config, configs.get_smoke_config):
        with pytest.raises(KeyError, match="unknown architecture"):
            get("no-such-model")


def test_sharded_serving_raises():
    """A mesh that is not a named DeviceMesh is refused (``collectives.check_mesh``); meshes run in
    tests/test_torch_lm_mesh.py."""
    cfg = configs.get_smoke_config("olmo-1b")
    for make in (serve_step.make_prefill_step, serve_step.make_decode_step):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make(cfg, mesh=object())
        fn, shardings = make(cfg)
        assert callable(fn) and shardings is None


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts(arch):
    """Weights (``UNCOUNTED`` aside, as ``param_count`` counts) at full width, and the smoke model's init."""
    def count(model):
        return sum(p.numel() for n, p in model.named_parameters() if not any(u in n for u in UNCOUNTED))

    def counted(cfg):  # ``param_count`` also leaves out an rglru block's feed-forward, which both models hold
        return cfg.param_count() + sum(cfg._ffn_params(cfg.d_ff) for kind in cfg.layer_kinds() if kind == "rglru")

    full = configs.get_config(arch)
    assert count(ttf.Transformer(full, device="meta")) == counted(full)
    smoke = configs.get_smoke_config(arch)
    model = ttf.init_model(smoke, 0, device="cpu")
    assert count(model) == counted(smoke)
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in model.parameters())
    # truncated normals at the reference's scales: |w| <= 2 / sqrt(d) on the embedding
    emb = model.embed
    assert float(emb.abs().max()) <= 2.0 / math.sqrt(smoke.d_model) + 1e-7
    assert 0.5 < float(emb.std()) * math.sqrt(smoke.d_model) < 1.0


def test_gemma2_full_width_counts():
    cfg = configs.get_config("gemma2-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_) == (26, 2304, 8, 4, 256)
    assert cfg.layer_kinds()[:2] == ("local", "global") and 2.6e9 < cfg.param_count() < 2.62e9


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norms(rng, kind):
    d = 48
    x = rng.standard_normal((2, 5, d)).astype(np.float32) * 3 + 1
    jp = {k: jnp.asarray(rng.standard_normal(d).astype(np.float32)) for k in jlayers.init_norm(kind, d, jnp.float32)}
    norm = tlayers.init_norm(kind, d, torch.float32)
    for name, val in jp.items():
        tlayers.fill_(getattr(norm, name), T(val))
    want = jlayers.apply_norm(jp, jnp.asarray(x), kind)
    np.testing.assert_allclose(norm(T(x)).numpy(), _np(want), atol=ATOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlps(rng, kind):
    d, ff = 32, 80
    jp = jlayers.init_mlp(jax.random.PRNGKey(1), kind, d, ff, jnp.float32)
    mlp = tlayers.MLP(kind, d, ff)
    for name, val in jp.items():
        tlayers.fill_(getattr(mlp, name), T(val))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    np.testing.assert_allclose(mlp(T(x)).numpy(), _np(jlayers.apply_mlp(jp, jnp.asarray(x), kind)), atol=ATOL)


@pytest.mark.parametrize("fraction,theta", [(1.0, 10000.0), (0.5, 10000.0), (1.0, 1e6)])
def test_rope(rng, fraction, theta):
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction=fraction, theta=theta)
    got = tlayers.apply_rope(T(x), T(pos).long(), fraction=fraction, theta=theta)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_softcap_and_sinusoids(rng):
    x = rng.standard_normal((4, 11)).astype(np.float32) * 40
    np.testing.assert_allclose(tlayers.softcap(T(x), 30.0).numpy(), _np(jlayers.softcap(jnp.asarray(x), 30.0)),
                               atol=ATOL)
    assert torch.equal(tlayers.softcap(T(x), None), T(x))
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(tlayers.sinusoidal_pos_emb(T(pos), 24).numpy(),
                               _np(jlayers.sinusoidal_pos_emb(jnp.asarray(pos), 24)), atol=ATOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_pair(rng, jcfg):
    """JAX attention params (random biases and norms included) and the port's module holding them."""
    jp = dict(jattn.init_attention(jax.random.PRNGKey(2), jcfg, jnp.float32))
    for name in ("bq", "bk", "bv"):
        if name in jp:
            jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape).astype(np.float32) * 0.3)
    for name in ("q_norm", "k_norm"):
        if name in jp:
            jp[name] = {"scale": jnp.asarray(rng.standard_normal(jp[name]["scale"].shape).astype(np.float32) * 0.3)}
    mod = tattn.Attention(_port_cfg(jcfg))
    for name, val in jp.items():
        if isinstance(val, dict):
            tlayers.fill_(getattr(mod, name).scale, T(val["scale"]))
        else:
            tlayers.fill_(getattr(mod, name), T(val))
    return jp, mod


_ATTN_CFGS = {
    "gemma2": jconfigs.get_smoke_config("gemma2-2b"),
    "chatglm3": jconfigs.get_smoke_config("chatglm3-6b"),
    "qk_norm": dataclasses.replace(jconfigs.get_smoke_config("qwen1.5-0.5b"), qk_norm=True, n_kv_heads=1),
}


@pytest.mark.parametrize("name", sorted(_ATTN_CFGS))
@pytest.mark.parametrize("local", [False, True])
def test_attend_full(rng, name, local):
    jcfg = _ATTN_CFGS[name]
    jp, mod = _attn_pair(rng, jcfg)
    b, s = 2, 40  # S > the gemma2 smoke window of 16
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    y_j, (k_j, v_j) = _attend_full(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, local=local)
    y_t, (k_t, v_t) = tattn.attend_full(mod, T(x), T(pos).long(), _port_cfg(jcfg), local=local)
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    np.testing.assert_allclose(k_t.numpy(), _np(k_j), atol=ATOL)
    np.testing.assert_allclose(v_t.numpy(), _np(v_j), atol=ATOL)


@pytest.mark.parametrize("name", sorted(_ATTN_CFGS))
@pytest.mark.parametrize("local,w,pos", [(False, 24, 17), (True, 16, 37), (False, 24, 5)])
def test_attend_decode(rng, name, local, w, pos):
    """One step against a random ring, before and after it wraps; the port updates in place."""
    jcfg = _ATTN_CFGS[name]
    jp, mod = _attn_pair(rng, jcfg)
    b, kv, hd = 2, jcfg.n_kv_heads, jcfg.head_dim_
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, w, kv, hd)).astype(np.float32) for _ in range(2))
    y_j, c_j = _attend_decode(jp, jnp.asarray(x), jnp.int32(pos), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                              jcfg, local=local)
    cache = {"k": T(ck), "v": T(cv)}
    y_t, c_t = tattn.attend_decode(mod, T(x), pos, cache, _port_cfg(jcfg), local=local)
    assert c_t is cache
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    np.testing.assert_allclose(c_t["k"].numpy(), _np(c_j["k"]), atol=ATOL)
    np.testing.assert_allclose(c_t["v"].numpy(), _np(c_j["v"]), atol=ATOL)


def test_cache_shapes():
    cfg = configs.get_smoke_config("gemma2-2b")
    assert tattn.cache_shape(cfg, 3, 10, True) == jattn.cache_shape(cfg, 3, 10, True) == (3, 10, 2, 16)
    assert tattn.cache_shape(cfg, 3, 40, True) == (3, 16, 2, 16)
    assert tattn.cache_shape(cfg, 3, 40, False) == (3, 40, 2, 16)
    caches = ttf.init_caches(cfg, 2, 40, device="cpu")
    assert [c["k"].shape[1] for c in caches] == [16, 40, 16, 40]


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _jax_layer_cache(caches, cfg, l):
    plen = len(cfg.pattern)
    n_cycled = cfg.n_layers // plen * plen
    if l < n_cycled:
        return {k: np.asarray(v[l // plen]) for k, v in caches["groups"][l % plen].items()}
    return {k: np.asarray(v) for k, v in caches["tail"][l - n_cycled].items()}


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_and_decode_match_jax(models, arch):
    """S = 32 >= the smoke window (16): both packages' caches have the same slots."""
    jcfg, params, cfg, model = models[arch]
    rng = np.random.default_rng(3)
    b, s = 2, 32
    toks = rng.integers(0, cfg.vocab_size, (b, s + 2)).astype(np.int32)
    lj, cj = _prefill(params, jcfg, jnp.asarray(toks[:, :s]))
    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    lt, ct = prefill(model, T(toks[:, :s]).long())
    assert lt.shape == (b, cfg.vocab_size) and len(ct) == cfg.n_layers
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL)
    for l in range(cfg.n_layers):
        ref = _jax_layer_cache(cj, jcfg, l)
        assert ct[l]["k"].shape == ref["k"].shape
        np.testing.assert_allclose(ct[l]["k"].numpy(), ref["k"], atol=ATOL)
        np.testing.assert_allclose(ct[l]["v"].numpy(), ref["v"], atol=ATOL)
    ldj, cj = _decode(params, jcfg, jnp.asarray(toks[:, s:s + 1]), jnp.int32(s), cj)
    ldt, ct2 = decode(model, T(toks[:, s:s + 1]).long(), s, ct)
    assert ct2 is ct  # updated in place
    np.testing.assert_allclose(ldt.numpy(), _np(ldj), atol=ATOL)
    for l in range(cfg.n_layers):
        np.testing.assert_allclose(ct[l]["k"].numpy(), _jax_layer_cache(cj, jcfg, l)["k"], atol=ATOL)


def test_bfloat16_tree_converts_bit_for_bit(models):
    jcfg, params, cfg, _ = models["gemma2-2b"]
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    bf = dataclasses.replace(cfg, param_dtype="bfloat16", activation_dtype="bfloat16")
    model = convert.lm_params_from_numpy(tree, bf, "cpu")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.layers[1].attn.wq.float().numpy(),
                                  _np(params["groups"][1]["attn"]["wq"][0].astype(jnp.bfloat16)))
    toks = torch.arange(12).reshape(2, 6)
    logits, caches = ttf.prefill_fn(model, bf, toks)
    assert logits.dtype == torch.bfloat16 and caches[0]["k"].dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_numpy({**tree, "final_norm": {}}, bf, "cpu")
    # a bf16 MoE tree keeps its router float32 (the reference draws it so whatever param_dtype is)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-moe-235b-a22b"), param_dtype="bfloat16",
                               activation_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jtf.init_model(jax.random.PRNGKey(1), jcfg))
    model = convert.lm_params_from_numpy(tree, _port_cfg(jcfg), "cpu")
    moe = model.layers[1].moe
    assert moe.router.dtype == torch.float32 and moe.w_gate.dtype == torch.bfloat16
    assert ttf.Transformer(_port_cfg(jcfg), device="meta").layers[0].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(moe.router.numpy(), tree["groups"][0]["moe"]["router"][1])
    np.testing.assert_array_equal(moe.w_down.float().numpy(), _np(tree["groups"][0]["moe"]["w_down"][1]))
    logits, _ = ttf.prefill_fn(model, _port_cfg(jcfg), toks)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", EMBED)
def test_embeddings_prefill_and_decode_match_jax(models, arch):
    """A (B, S, d) prompt of embeddings, then two decoded tokens: the prefill and the first step against the JAX
    package's; both steps against a full forward over the prompt followed by ``embed[tokens]``, in the port and in
    the JAX package (the reference's global ring holds S + 1 slots, so its own decode stops at one step)."""
    jcfg, params, cfg, model = models[arch]
    rng = np.random.default_rng(5)
    b, s = 2, 32
    prompt = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, 2)).astype(np.int32)
    lj, cj = _prefill(params, jcfg, jnp.asarray(prompt))
    lt, ct = ttf.prefill_fn(model, cfg, T(prompt), cache_len=s + 2)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL)
    ldj, _ = _decode(params, jcfg, jnp.asarray(toks[:, :1]), jnp.int32(s), cj)
    emb = np.asarray(params["embed"])
    for i in range(2):
        ldt, ct = ttf.decode_fn(model, cfg, T(toks[:, i:i + 1]).long(), s + i, ct)
        if i == 0:
            np.testing.assert_allclose(ldt.numpy(), _np(ldj), atol=ATOL)
        seq = np.concatenate([prompt, emb[toks[:, :i + 1]]], 1)
        np.testing.assert_allclose(ldt.numpy(), _np(_prefill(params, jcfg, jnp.asarray(seq))[0]), atol=ATOL)
        np.testing.assert_allclose(ldt.numpy(), ttf.prefill_fn(model, cfg, T(seq))[0].numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# the reference's cache fault: the port's decode against the JAX full forward
# ---------------------------------------------------------------------------


def _greedy_against_full_forward(models, arch, s, n_steps):
    """Decode n_steps tokens after a prefill of s; each step's logits against a
    full JAX forward over the tokens so far.  Returns (port gaps, JAX decode gaps)."""
    jcfg, params, cfg, model = models[arch]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, s + n_steps)).astype(np.int32)
    _, ct = ttf.prefill_fn(model, cfg, T(toks[:, :s]).long(), cache_len=s + n_steps)
    _, cj = _prefill(params, jcfg, jnp.asarray(toks[:, :s]))
    port, ref = [], []
    for i in range(n_steps):
        pos = s + i
        full, _ = _prefill(params, jcfg, jnp.asarray(toks[:, :pos + 1]))
        lt, ct = ttf.decode_fn(model, cfg, T(toks[:, pos:pos + 1]).long(), pos, ct)
        lj, cj = _decode(params, jcfg, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos), cj)
        port.append(float(np.abs(lt.numpy() - _np(full)).max()))
        ref.append(float(np.abs(_np(lj) - _np(full)).max()))
    return port, ref


def test_decode_matches_full_forward_below_the_window(models):
    """gemma2 smoke, S = 8 < window 16: the reference's local ring has 8 slots."""
    port, ref = _greedy_against_full_forward(models, "gemma2-2b", 8, 1)
    assert port[0] <= ATOL
    assert ref[0] > 100 * ATOL  # the JAX decode overwrote position 0


def test_second_decoded_token_on_global_layers(models):
    """olmo smoke (global layers only), cache_len = S + 2: the reference's ring has S + 1 slots."""
    port, ref = _greedy_against_full_forward(models, "olmo-1b", 32, 2)
    assert max(port) <= ATOL
    assert ref[0] <= ATOL and ref[1] > 100 * ATOL  # the JAX decode evicted position 0 at step 2


def test_decode_matches_full_forward_reference_case(models):
    """gemma2 smoke, S = 32 > window: both packages decode the full forward's logits."""
    port, ref = _greedy_against_full_forward(models, "gemma2-2b", 32, 1)
    assert port[0] <= ATOL and ref[0] <= ATOL
