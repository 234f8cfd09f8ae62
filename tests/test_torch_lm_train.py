"""The port's language-model training against the JAX package's.

``transformer.loss_fn`` and its gradients, one ``make_train_step`` step with
Adam and with Adafactor, the synthetic data, and the flash op's gradient
route, on the four dense smoke configurations in float32 on the CPU (the
flash op runs its plain version forward, the reference's masked softmax
backward).  The recurrentgemma, mamba2, two mixture-of-experts (qwen3-moe,
arctic) and two embeddings-input (llava, musicgen: (B, S, d) float inputs,
token labels) smoke configurations take the loss, gradient and finiteness
cases; qwen3-moe's also takes an Adafactor step (3-D expert leaves).  Parameters come over by
``convert.lm_params_from_numpy``;
inputs are drawn with numpy.  Tolerances: the loss within 1e-5 relative;
a gradient within 1e-4 max|g| + 1e-6 of ``jax.grad`` (measured gaps
~2e-6 max|g|); parameters after a step within 1e-5 wherever the reference's
gradient is resolved (|g| above the gradient tolerance, 1e-4 max|g|).  A
first step of Adam, or of Adafactor on an unfactored leaf, moves a
parameter by about lr g / |g|, lr whatever |g| is, so that where g is at
its rounding level (a key bias, whose gradient is 0 in exact arithmetic,
or a component of ~1e-8) the step's sign is the rounding's, in the
reference as in the port: there a parameter is held to the step's own
bound, lr (1 + wd |p|).  The Adam step's first moments, linear in g, are
held to 1e-5 relative everywhere.

The reference stacks each pattern position's layers into one leaf; the
port keeps one leaf a layer.  Adam is element-wise with one global norm,
so the reference's step on its stacked tree is the port's; Adafactor's
factored moments and RMS clip read a whole leaf, so its reference step
runs the JAX ``Adafactor`` on the port's per-layer tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsynth
from repro.models import transformer as jtf
from repro.optim import Adafactor as JAdafactor
from repro.optim import Adam as JAdam
from repro.train.train_step import make_train_step as jmake_train_step
import _jax_ref
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs, convert
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import transformer as ttf
from repro_torch.optim import Adafactor, Adam, global_norm
from repro_torch.train import make_train_step
from repro_torch.train.train_step import loss_and_grads

DENSE = ("gemma2-2b", "olmo-1b", "qwen1.5-0.5b", "chatglm3-6b")
PORTED = DENSE + ("recurrentgemma-2b", "mamba2-1.3b", "qwen3-moe-235b-a22b", "arctic-480b", "llava-next-34b",
                  "musicgen-large")
B, S = 2, 32
# the JAX package's loss and gradients, compiled: eager, the recurrent kinds' scans compile op by op
_jax_value_and_grad = _jax_ref.jit(jax.value_and_grad(jtf.loss_fn), static_argnums=1)


def _cfgs(arch, chunk=0):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), attn_chunk=chunk, loss_chunk=chunk)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), attn_chunk=chunk, loss_chunk=chunk)
    return jcfg, cfg


def _batch(cfg, seed=0):
    """(inputs, labels): (B, S) tokens, or (B, S, d) embeddings for the embeddings input; (B, S) token labels."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return inputs, rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_tree(tree, cfg):
    """A JAX parameter-shaped tree (numpy leaves) as the port's name -> tensor dict."""
    return dict(convert.lm_params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu").named_parameters())


def _hold_step(got, want, grad, before, bound):
    """Within 1e-5 where the reference's gradient is resolved; within the step's bound elsewhere."""
    resolved = grad.abs() > 1e-4 * grad.abs().max()
    diff = (got - want).abs()
    assert float(torch.where(resolved, diff, 0.0).max()) <= 1e-5
    assert bool(torch.where(resolved, True, diff <= 2 * bound + 1e-5).all())


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX params), built once."""
    init = _jax_ref.jit(jtf.init_model, static_argnums=1)
    return {arch: init(jax.random.PRNGKey(0), jconfigs.get_smoke_config(arch)) for arch in PORTED}


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_gradients_match_jax(models, arch, chunk):
    jcfg, cfg = _cfgs(arch, chunk)
    params = models[arch]
    tok, lab = _batch(cfg)
    jl, jg = _jax_value_and_grad(params, jcfg, jnp.asarray(tok), jnp.asarray(lab))
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    loss, grads = loss_and_grads(model, cfg, torch.from_numpy(tok), torch.from_numpy(lab))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want = _port_tree(jg, cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        assert (g - w).abs().max() <= 1e-4 * w.abs().max() + 1e-6, name
    assert all(not p.requires_grad for p in model.parameters())  # the flags are given back


@pytest.mark.parametrize("arch", PORTED)
def test_train_step_finite(arch):
    """The reference's smoke property: a finite loss and a finite, nonzero gradient norm."""
    cfg = configs.get_smoke_config(arch)
    model = ttf.init_model(cfg, 0, device="cpu")
    tok, lab = _batch(cfg, seed=1)
    loss, grads = loss_and_grads(model, cfg, torch.from_numpy(tok), torch.from_numpy(lab))
    gn = float(global_norm(grads))
    assert np.isfinite(float(loss)) and np.isfinite(gn) and gn > 0.0


@pytest.mark.parametrize("arch", ["olmo-1b"])
def test_adam_step_matches_jax(models, arch):
    jcfg, cfg = _cfgs(arch, 8)
    params = models[arch]
    tok, lab = _batch(cfg, seed=2)
    jopt = JAdam(learning_rate=1e-3, weight_decay=0.1)
    jstep, _ = jmake_train_step(jcfg, jopt, donate=False)
    jp, jo, jl = jstep(params, jopt.init(params), jnp.asarray(tok), jnp.asarray(lab))
    opt = Adam(learning_rate=1e-3, weight_decay=0.1)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    params_before = {n: p.clone() for n, p in model.named_parameters()}
    step, sh = make_train_step(cfg, opt)
    model, state, loss = step(model, opt.init(model), torch.from_numpy(tok), torch.from_numpy(lab))
    assert sh is None and int(state["step"]) == 1
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    _, jg = _jax_value_and_grad(params, jcfg, jnp.asarray(tok), jnp.asarray(lab))
    want, grads = _port_tree(jp, cfg), _port_tree(jg, cfg)
    for name, p in model.named_parameters():
        _hold_step(p, want[name], grads[name], params_before[name], 1e-3 * (1 + 0.1 * params_before[name].abs()))
    want_m = _port_tree(jo["m"], cfg)
    for name, m in state["m"].items():
        assert (m - want_m[name]).abs().max() <= 1e-5 * want_m[name].abs().max() + 1e-9, name


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-235b-a22b"])
def test_adafactor_step_matches_jax(models, arch):
    jcfg, cfg = _cfgs(arch)
    params = models[arch]
    tok, lab = _batch(cfg, seed=3)
    _, jg = _jax_value_and_grad(params, jcfg, jnp.asarray(tok), jnp.asarray(lab))
    # the reference optimizer on the port's per-layer tree (see the module docstring)
    jflat = {n: jnp.asarray(t.numpy()) for n, t in _port_tree(params, cfg).items()}
    jgrads = {n: jnp.asarray(t.numpy()) for n, t in _port_tree(jg, cfg).items()}
    jopt = JAdafactor(learning_rate=1e-2, min_dim_size_to_factor=16)
    jnew, jstate = _jax_ref.jit(jopt.update)(jgrads, jopt.init(jflat), jflat)
    opt = Adafactor(learning_rate=1e-2, min_dim_size_to_factor=16)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    state = opt.init(model)
    assert any("vr" in v for v in state["v"].values())  # some leaves factor at this size
    step, _ = make_train_step(cfg, opt)
    model, state, loss = step(model, state, torch.from_numpy(tok), torch.from_numpy(lab))
    assert np.isfinite(float(loss)) and int(state["step"]) == 1
    grads = _port_tree(jg, cfg)
    for name, p in model.named_parameters():
        _hold_step(p, torch.from_numpy(np.array(jnew[name])), grads[name], None, 1e-2)
    for name, v in state["v"].items():
        for key, t in v.items():
            w = torch.from_numpy(np.array(jstate["v"][name][key]))
            assert t.shape == w.shape and (t - w).abs().max() <= 1e-4 * w.abs().max(), (name, key)


def test_donate_false_leaves_its_inputs(models):
    jcfg, cfg = _cfgs("olmo-1b")
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, models["olmo-1b"]), cfg, "cpu")
    opt = Adam(learning_rate=1e-2)
    state = opt.init(model)
    before = {n: p.clone() for n, p in model.named_parameters()}
    tok, lab = (torch.from_numpy(a) for a in _batch(cfg))
    step, _ = make_train_step(cfg, opt, donate=False)
    new_model, new_state, _ = step(model, state, tok, lab)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert int(state["step"]) == 0 and all(float(m.abs().max()) == 0.0 for m in state["m"].values())
    assert any(not torch.equal(p, before[n]) for n, p in new_model.named_parameters())
    assert int(new_state["step"]) == 1
    donated, _ = make_train_step(cfg, opt)
    out, out_state, _ = donated(model, state, tok, lab)
    assert out is model and out_state is state and int(state["step"]) == 1
    assert all(torch.equal(p, dict(new_model.named_parameters())[n]) for n, p in model.named_parameters())


def test_synthetic_data_is_the_references():
    ours = list(synthetic.token_batches(97, 3, 40, seed=5, n_batches=3))
    theirs = list(jsynth.token_batches(97, 3, 40, seed=5, n_batches=3))
    for (t, l), (jt, jl) in zip(ours, theirs):
        assert t.dtype == jt.dtype and np.array_equal(t, jt) and np.array_equal(l, jl)
    x, y = synthetic.gp_function_draw(64, 2, lengthscale=0.7, seed=3)
    jx, jy = jsynth.gp_function_draw(64, 2, lengthscale=0.7, seed=3)
    assert np.array_equal(x, jx) and np.array_equal(y, jy)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_backward_on_the_card_route_is_autograd_of_the_plain_version(monkeypatch, window):
    """``ops.flash_attention`` under grad with ``_on_cuda`` patched: the kernel (a stand-in) forward,
    counted; the backward is autograd of the reference given, by default the plain version."""
    calls = []

    def kernel(q, k, v, **kw):
        calls.append(kw)
        return flash_attention_plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "_on_cuda", lambda t, op: True)
    monkeypatch.setattr(ops._flash, "flash_attention_cuda", kernel)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 12, 4, 8, generator=gen, dtype=torch.float64) for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    cot = torch.randn(2, 12, 4, 8, generator=gen, dtype=torch.float64)
    ops.reset_launch_counts()
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*args, softcap=3.0, window=window)
    got = torch.autograd.grad(out, args, cot)
    assert ops.launch_counts()["flash_attention"] == 1 and calls == [dict(causal=True, softcap=3.0, window=window)]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, softcap=3.0, window=window), ref, cot)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=0, atol=1e-12)
    with torch.no_grad():  # no grad: the kernel alone, no graph
        assert ops.flash_attention(q, k, v).grad_fn is None
