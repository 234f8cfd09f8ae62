"""The port's optimizers, schedule and gradient compression against the JAX package's.

The seven cases of ``tests/test_optim.py``, each also run through the
reference on the same trees: 20 Adam and Adafactor steps on the quadratic
problem, each step within 1e-6 of the reference's from the same params,
gradients and state (then the convergence properties alone), the factored
state's shapes, the clip, ``cosine_warmup`` and ``global_norm`` (within
1e-6), and the int8 compressor (payloads equal, error feedback bounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import Adafactor as JAdafactor
from repro.optim import Adam as JAdam
from repro.optim import cosine_warmup as jcosine_warmup
from repro.optim.adam import global_norm as jglobal_norm
from repro.optim.compression import compress as jcompress
from repro.optim.compression import compress_with_feedback as jcompress_with_feedback
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.optim import Adafactor, Adam, cosine_warmup, global_norm
from repro_torch.optim.compression import compress, compress_with_feedback, decompress
from repro_torch.tree import leaves_with_paths, map_tree

TARGET = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)


def _loss(p):
    return ((p["w"] - torch.from_numpy(TARGET)) ** 2).sum() + ((p["b"] - 1.0) ** 2).sum()


def _jloss(p):
    return jnp.sum((p["w"] - TARGET) ** 2) + jnp.sum((p["b"] - 1.0) ** 2)


def _run(opt, jopt, steps):
    """The port's params after ``steps`` steps from zeros, and its initial loss.

    With ``jopt`` every step is also taken by the reference from the port's
    own params, gradients and state (the same trees), and the two held
    within 1e-6, so that rounding does not compound over the trajectory.
    """
    params = {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
    init = float(_loss(params))
    state = opt.init(params)
    for _ in range(steps):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        grads = dict(zip(p, torch.autograd.grad(_loss(p), list(p.values()))))
        if jopt is not None:
            jnew, jstate = jopt.update(map_tree(_jx, grads), map_tree(_jx, state), map_tree(_jx, params))
        opt.update(grads, state, params)
        if jopt is not None:
            _close(params, jnew)
            jleaves = dict(leaves_with_paths(jstate))
            for path, t in leaves_with_paths(state):
                assert np.abs(t.numpy() - np.asarray(jleaves[path])).max() <= 1e-6 * (1 + np.abs(t.numpy()).max())
    return params, init


def _jx(t):
    return jnp.asarray(t.numpy())


def _close(params, jparams, tol=1e-6):
    for k, v in params.items():
        assert np.abs(v.numpy() - np.asarray(jparams[k])).max() <= tol, k


@pytest.mark.parametrize("lr", [0.1, 0.02])
def test_adam_converges(lr):
    params, _ = _run(Adam(learning_rate=lr, weight_decay=0.01), JAdam(learning_rate=lr, weight_decay=0.01), 20)
    if lr == 0.1:
        params, _ = _run(Adam(learning_rate=0.1), None, 200)
        assert float(_loss(params)) < 1e-2


def test_adafactor_converges():
    _run(Adafactor(learning_rate=0.3, min_dim_size_to_factor=4), JAdafactor(learning_rate=0.3, min_dim_size_to_factor=4),
         20)
    params, init = _run(Adafactor(learning_rate=0.3), None, 300)
    assert float(_loss(params)) < 0.02 * init


def test_adafactor_memory_is_factored():
    params = {"big": torch.zeros(512, 256), "small": torch.zeros(8), "cube": torch.zeros(4, 64, 48)}
    state = Adafactor().init(params)
    jstate = JAdafactor().init({k: jnp.zeros(v.shape) for k, v in params.items()})
    v_big = state["v"]["big"]
    assert set(v_big) == {"vr", "vc"}
    assert v_big["vr"].shape == (512,) and v_big["vc"].shape == (256,)
    assert state["v"]["small"]["v"].shape == (8,)
    for name, v in state["v"].items():
        assert {k: tuple(t.shape) for k, t in v.items()} == {k: t.shape for k, t in jstate["v"][name].items()}
        assert all(t.dtype == torch.float32 for t in v.values())


def test_adam_clip_norm():
    opt, jopt = Adam(learning_rate=1.0, clip_norm=1.0), JAdam(learning_rate=1.0, clip_norm=1.0)
    params, huge = {"w": torch.zeros(4)}, {"w": torch.full((4,), 1e6)}
    new_params, _ = opt.update(huge, opt.init(params), params)
    jnew, _ = jopt.update({"w": jnp.full((4,), 1e6)}, jopt.init({"w": jnp.zeros((4,))}), {"w": jnp.zeros((4,))})
    # with clipping, the first Adam step is bounded by lr
    assert float(new_params["w"].abs().max()) < 2.0
    _close(new_params, jnew)


def test_cosine_warmup_schedule():
    s, js = cosine_warmup(1.0, warmup=10, total=110, floor=0.1), jcosine_warmup(1.0, warmup=10, total=110, floor=0.1)
    assert s(0) == 0.0 and s(10) == 1.0 and abs(s(110) - 0.1) < 1e-6 and s(5) == 0.5
    for step in (0, 3, 10, 11, 57, 109, 110, 500):
        assert abs(s(step) - float(js(step))) <= 1e-6, step


def test_global_norm():
    t = {"a": torch.ones(3), "b": torch.full((4,), 2.0), "c": [torch.full((2, 2), 0.5, dtype=torch.bfloat16)]}
    jt = {"a": jnp.ones((3,)), "b": jnp.full((4,), 2.0), "c": [jnp.full((2, 2), 0.5, jnp.bfloat16)]}
    assert abs(float(global_norm(t)) - np.sqrt(3 + 16 + 1)) < 1e-6
    assert abs(float(global_norm(t)) - float(jglobal_norm(jt))) < 1e-6


def test_error_feedback_accumulates():
    """Error feedback keeps the running sum of dequantized gradients within one step of the true one; the
    int8 payloads and scales are the reference's."""
    rng = np.random.default_rng(1)
    g_total = np.zeros(100, np.float32)
    d_total = np.zeros(100, np.float32)
    err = torch.zeros(100)
    jerr = jnp.zeros((100,), jnp.float32)
    for _ in range(20):
        g_np = rng.standard_normal(100).astype(np.float32)
        g = torch.from_numpy(g_np)
        q, s, err = compress_with_feedback(g, err, chunk=50)
        jq, js, jerr = jcompress_with_feedback(jnp.asarray(g_np), jerr, chunk=50)
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(s.numpy(), np.asarray(js))
        d = decompress(q, s, g.shape, g.numel())
        g_total += g_np
        d_total += d.numpy()
    resid = np.abs(g_total - d_total).max()
    assert resid <= float(err.abs().max()) + 1e-5
    assert np.abs(err.numpy() - np.asarray(jerr)).max() <= 1e-6
    x = rng.standard_normal((3, 37)).astype(np.float32) * 5
    q, s = compress(torch.from_numpy(x), chunk=16)
    jq, js = jcompress(jnp.asarray(x), chunk=16)
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
