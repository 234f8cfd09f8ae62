"""The port's recurrent layer kinds (rglru, mamba2) against the JAX package's.

``layers.linear_scan`` against ``jax.lax.associative_scan`` and a sequential
loop; ``rglru.apply_rglru_seq``/``apply_rglru_step`` and
``mamba2.apply_mamba2_seq``/``apply_mamba2_step`` against the reference's
functions on the same parameters (mamba2 also at a prime length, where the
port pads its last chunk and the reference falls back to chunks of one
token); ``prefill_fn`` and four ``decode_fn`` steps of the recurrentgemma
and mamba2 smoke models; and decoding after a 1- and a 2-token prompt,
where the reference's own decode fails on its short conv state (ROADMAP.md
§3 item 4), against the reference's full forward over the same tokens.
Float32 on the CPU, parameters carried by ``convert``, inputs drawn with
numpy.  Tolerance: ``ATOL`` = 1e-4, as ``tests/test_torch_models.py``
(float32 sums in another order; the measured gaps are ~2e-6).  The JAX
functions run under ``jax.jit`` (``_jax_ref.jit``): eager, the reference's
scans compile op by op.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba2 as jm2
from repro.models import rglru as jrg
from repro.models import transformer as jtf
from repro.optim import Adafactor as JAdafactor
from repro.optim import Adam as JAdam
import _jax_ref
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs, convert
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttf
from repro_torch.optim import Adafactor, Adam
from repro_torch.train import serve_step

ATOL = 1e-4
RECURRENT = ("recurrentgemma-2b", "mamba2-1.3b")

_init = _jax_ref.jit(jtf.init_model, static_argnums=1)
_prefill = _jax_ref.jit(jtf.prefill_fn, static_argnums=1)
_decode = _jax_ref.jit(jtf.decode_fn, static_argnums=1)


def T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, JAX params, port config, port model), built once."""
    out = {}
    for arch in RECURRENT:
        jcfg = jconfigs.get_smoke_config(arch)
        params = _init(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_smoke_config(arch)
        out[arch] = (jcfg, params, cfg, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu"))
    return out


def _module(cls, jp, cfg):
    """The port's module holding the reference's parameters ``jp``."""
    mod = cls(ModelConfig(**dataclasses.asdict(cfg)))
    for name, val in jp.items():
        tlayers.fill_(getattr(mod, name), T(val))
    return mod


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


def _combine(l, r):
    (al, bl), (ar, br) = l, r
    return al * ar, ar.reshape(ar.shape + (1,) * (bl.ndim - ar.ndim)) * bl + br


@pytest.mark.parametrize("a_shape,tail", [((2, 1, 3), ()), ((2, 37, 5), ()), ((2, 16, 3), (4, 6))],
                         ids=["s1", "s37", "s16_trailing"])
def test_linear_scan(rng, a_shape, tail):
    a = rng.uniform(0.3, 1.0, a_shape).astype(np.float32)
    b = rng.standard_normal(a_shape + tail).astype(np.float32)
    got = tlayers.linear_scan(T(a), T(b)).numpy()
    scan = _jax_ref.jit(lambda a, b: jax.lax.associative_scan(_combine, (a, b), axis=1))
    _, want = scan(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got, _np(want), atol=1e-5)
    h, loop = np.zeros((a_shape[0],) + a_shape[2:] + tail, np.float64), []
    for t in range(a_shape[1]):
        h = a[:, t].reshape(a[:, t].shape + (1,) * len(tail)) * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(got, np.stack(loop, 1), atol=1e-5)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _rglru_pair(rng):
    jcfg = jconfigs.get_smoke_config("recurrentgemma-2b")
    jp = dict(jrg.init_rglru(jax.random.PRNGKey(5), jcfg, jnp.float32))
    for name in ("conv_b", "b_a", "b_i"):  # nonzero biases, so that each is used
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape).astype(np.float32) * 0.3)
    return jcfg, jp, _module(trg.RGLRU, jp, jcfg)


def _mamba2_pair(rng):
    jcfg = jconfigs.get_smoke_config("mamba2-1.3b")
    jp = dict(jm2.init_mamba2(jax.random.PRNGKey(6), jcfg, jnp.float32))
    for name in ("conv_b", "d_skip", "norm_scale"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape).astype(np.float32) * 0.3 + 1.0)
    return jcfg, jp, _module(tm2.Mamba2, jp, jcfg)


def _hold_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=ATOL, err_msg=k)


def test_rglru_seq(rng):
    jcfg, jp, mod = _rglru_pair(rng)
    x = rng.standard_normal((2, 19, jcfg.d_model)).astype(np.float32)
    y_j, s_j = _jax_ref.jit(jrg.apply_rglru_seq, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    y_t, s_t = trg.apply_rglru_seq(mod, T(x), configs.get_smoke_config("recurrentgemma-2b"))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    _hold_state(s_t, s_j)


def test_rglru_step(rng):
    jcfg, jp, mod = _rglru_pair(rng)
    cfg = configs.get_smoke_config("recurrentgemma-2b")
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, cfg.rnn_width_)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.conv_width - 1, cfg.rnn_width_)).astype(np.float32)
    state_j = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
    y_j, s_j = _jax_ref.jit(jrg.apply_rglru_step, static_argnums=3)(jp, jnp.asarray(x), state_j, jcfg)
    state = {"h": T(h), "conv": T(conv)}
    y_t, s_t = trg.apply_rglru_step(mod, T(x), state, cfg)
    assert s_t is state  # updated in place
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    _hold_state(s_t, s_j)


@pytest.mark.parametrize("s", [32, 37], ids=["chunk_multiple", "prime"])
def test_mamba2_seq(rng, s):
    """S = 32 is 4 chunks of 8; at S = 37 the port pads a fifth chunk and the reference takes 37 chunks of one."""
    jcfg, jp, mod = _mamba2_pair(rng)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    y_j, s_j = _jax_ref.jit(jm2.apply_mamba2_seq, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    y_t, s_t = tm2.apply_mamba2_seq(mod, T(x), configs.get_smoke_config("mamba2-1.3b"))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    _hold_state(s_t, s_j)


def test_mamba2_step(rng):
    jcfg, jp, mod = _mamba2_pair(rng)
    cfg = configs.get_smoke_config("mamba2-1.3b")
    d_in, h, pd, n = tm2._dims(cfg)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    hs = rng.standard_normal((2, h, n, pd)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.conv_width - 1, d_in + 2 * n)).astype(np.float32)
    state_j = {"h": jnp.asarray(hs), "conv": jnp.asarray(conv)}
    y_j, s_j = _jax_ref.jit(jm2.apply_mamba2_step, static_argnums=3)(jp, jnp.asarray(x), state_j, jcfg)
    state = {"h": T(hs), "conv": T(conv)}
    y_t, s_t = tm2.apply_mamba2_step(mod, T(x), state, cfg)
    assert s_t is state
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    _hold_state(s_t, s_j)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _jax_layer_cache(caches, cfg, l):
    plen = len(cfg.pattern)
    n_cycled = cfg.n_layers // plen * plen
    if l < n_cycled:
        return {k: np.asarray(v[l // plen]) for k, v in caches["groups"][l % plen].items()}
    return {k: np.asarray(v) for k, v in caches["tail"][l - n_cycled].items()}


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_and_decode_match_jax(models, arch):
    """S = 32, four decode steps; every layer's cache after the prefill and after the steps."""
    jcfg, params, cfg, model = models[arch]
    rng = np.random.default_rng(3)
    b, s, steps = 2, 32, 4
    toks = rng.integers(0, cfg.vocab_size, (b, s + steps)).astype(np.int32)
    lj, cj = _prefill(params, jcfg, jnp.asarray(toks[:, :s]))
    (prefill, _), (decode, _) = serve_step.make_prefill_step(cfg), serve_step.make_decode_step(cfg)
    lt, ct = prefill(model, T(toks[:, :s]).long(), s + steps)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL)
    want_shapes = [{k: tuple(v.shape) for k, v in c.items()}
                   for c in ttf.init_caches(cfg, b, s + steps, device="meta")]
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in ct] == want_shapes
    for l in range(cfg.n_layers):
        if cfg.layer_kinds()[l] != "local":  # the reference's ring is sized otherwise (tests/test_torch_models.py)
            _hold_state(ct[l], _jax_layer_cache(cj, jcfg, l))
    kept = [{k: v.clone() for k, v in c.items()} for c in ct]
    copy, _ = serve_step.make_decode_step(cfg, donate_cache=False)
    copy(model, T(toks[:, s:s + 1]).long(), s, ct)
    assert all(torch.equal(c[k], k0[k]) for c, k0 in zip(ct, kept) for k in c)
    for i in range(steps):
        pos = s + i
        ldj, cj = _decode(params, jcfg, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos), cj)
        ldt, ct2 = decode(model, T(toks[:, pos:pos + 1]).long(), pos, ct)
        assert ct2 is ct  # updated in place
        np.testing.assert_allclose(ldt.numpy(), _np(ldj), atol=ATOL)
    for l in range(cfg.n_layers):
        if cfg.layer_kinds()[l] != "local":
            _hold_state(ct[l], _jax_layer_cache(cj, jcfg, l))


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_after_a_short_prompt(models, arch, s):
    """A prompt shorter than conv_width - 1: the reference's decode raises on its short conv state; the port's
    decoded logits are held to the reference's full forward over the tokens so far."""
    jcfg, params, cfg, model = models[arch]
    rng = np.random.default_rng(4)
    steps = 3
    toks = rng.integers(0, cfg.vocab_size, (2, s + steps)).astype(np.int32)
    _, cj = _prefill(params, jcfg, jnp.asarray(toks[:, :s]))
    with pytest.raises(ValueError, match="label 'c'"):
        _decode(params, jcfg, jnp.asarray(toks[:, s:s + 1]), jnp.int32(s), cj)
    _, ct = ttf.prefill_fn(model, cfg, T(toks[:, :s]).long(), cache_len=s + steps)
    assert all(c["conv"].shape[1] == cfg.conv_width - 1 for c in ct if "conv" in c)
    for i in range(steps):
        pos = s + i
        full, _ = _prefill(params, jcfg, jnp.asarray(toks[:, :pos + 1]))
        lt, ct = ttf.decode_fn(model, cfg, T(toks[:, pos:pos + 1]).long(), pos, ct)
        np.testing.assert_allclose(lt.numpy(), _np(full), atol=ATOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_draws(arch):
    """The port's own init at the reference's ranges: RG-LRU decay a = exp(-8 softplus(Λ)) in (0.9, 0.999) at
    r = 1; Mamba-2's A = exp(a_log) in [1, 16] and Δ = softplus(dt_bias) in [1e-3, 0.1]; zero conv biases."""
    cfg = configs.get_smoke_config(arch)
    model = ttf.init_model(cfg, 0, device="cpu")
    for kind, blk in zip(cfg.layer_kinds(), model.layers):
        if kind == "rglru":
            a = torch.exp(-8.0 * torch.nn.functional.softplus(getattr(blk.rec, "lambda")))
            assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
            assert not blk.rec.conv_b.any() and not blk.rec.b_a.any()
        elif kind == "mamba2":
            a = torch.exp(blk.ssm.a_log)
            dt = torch.nn.functional.softplus(blk.ssm.dt_bias)
            assert 1.0 - 1e-5 <= float(a.min()) and float(a.max()) <= 16.0 + 1e-4
            assert 1e-3 * (1 - 1e-4) <= float(dt.min()) and float(dt.max()) <= 0.1 * (1 + 1e-4)
            assert not blk.ssm.conv_b.any() and bool((blk.ssm.d_skip == 1).all())
            assert not hasattr(blk, "mlp") and not hasattr(blk, "norm2")
    if arch == "recurrentgemma-2b":  # Λ under the reference's name, a Python keyword
        assert "layers.0.rec.lambda" in model.state_dict()


@pytest.mark.parametrize("opt", ["adam", "adafactor"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_optimizer_state_converts(models, arch, opt):
    """``convert.lm_opt_state_from_numpy`` takes the rec.* and ssm.* moments of the reference's state, each
    layer's bitwise its stacked leaf's cycle."""
    jcfg, params, cfg, model = models[arch]
    jopt = JAdam(learning_rate=1e-3) if opt == "adam" else JAdafactor(learning_rate=1e-3, min_dim_size_to_factor=4)
    port_opt = Adam(learning_rate=1e-3) if opt == "adam" else Adafactor(learning_rate=1e-3, min_dim_size_to_factor=4)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    _, jstate = _jax_ref.jit(jopt.update)(grads, jopt.init(params), params)
    state = convert.lm_opt_state_from_numpy(jax.tree.map(np.asarray, jstate), model, port_opt)
    moments = state["m"] if opt == "adam" else state["v"]
    names = [n for n in moments if ".rec." in n or ".ssm." in n]
    assert names and int(state["step"]) == 1
    if opt == "adafactor":  # the 2-D conv weights factor at this threshold
        assert all(set(moments[n]) == {"vr", "vc"} for n in names if n.endswith("conv_w"))
    plen = len(cfg.pattern)
    n_cycled = cfg.n_layers // plen * plen
    tree = jstate["m"] if opt == "adam" else jstate["v"]
    for name in names:
        l, rest = int(name.split(".")[1]), name.split(".")[2:]
        leaf, index = (tree["groups"][l % plen], l // plen) if l < n_cycled else (tree["tail"][l - n_cycled], None)
        for k in rest:
            leaf = leaf[k]
        got = moments[name]
        for key, t in (got.items() if isinstance(got, dict) else [(None, got)]):
            src = np.asarray(leaf[key] if key else leaf)
            assert np.array_equal(t.numpy(), src if index is None else src[index]), (name, key)
