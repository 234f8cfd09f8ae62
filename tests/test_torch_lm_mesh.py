"""The language model's meshes: sharded train and serve steps in one spawned 4-rank gloo world, against the JAX package.

The olmo smoke model, with the reference's weights (``convert``), on a
(2, 2) ``("data", "model")`` mesh of CPU ranks (``tests/_torch_dist.py``):
one sharded ``make_train_step`` step (Adam and Adafactor) against the
unsharded one within 1e-5 (parameters, states and loss); every parameter's
and moment's spec against the reference's ``_leaf_spec`` and the input's
against its ``batch_spec``, computed here on an object with the same axis
sizes; the bytes each rank holds; the compressed data-parallel step on a
``("pod", "data")`` mesh against the plain step (the reference's rule: loss
within 1e-2, parameters within 5e-2; every rank's parameters the same);
prefill and four decode steps under the mesh against unsharded ones within
1e-5, for olmo, for recurrentgemma's smoke model (its rglru states and
local rings) and for qwen3-moe's at capacity factor 0.5 (drops), whose
routing groups hold both data ranks' rows; a sharded step of llava's smoke
model on (B, S, d) embeddings against the unsharded one within 1e-5; and a
checkpoint saved from the sharded state restored unsharded and sharded,
bitwise.

While the world runs, the JAX package takes the same steps on the same
weights and tokens: the unsharded Adam and Adafactor steps and the forward
in process (the reference's rule: shardings change layout, not results),
and its own ``make_compressed_dp_step`` on a (2, 2) ``("pod", "data")``
mesh of four host devices in a subprocess.  The sharded steps are held to
them as ``tests/test_torch_lm_train.py`` holds the unsharded step: the loss
within 1e-5 relative, parameters within 1e-5 where the reference's gradient
is resolved and within a first step's bound elsewhere, Adam's first moments
within 1e-5 of their parameter's largest.  The compressed step quantizes
gradients that agree with the reference's to rounding, so a value that
lies on a rounding boundary of the int8 grid can land one step away: its
parameters (within 1e-5), moments and error-feedback buffers (within 1e-5
of their gradient's largest component, whose rounding they carry) are held
so everywhere but at most one component in a thousand, and there to one
quantum (the step's bound 2 lr for parameters).  The port compresses each
layer's leaf and the reference each stacked leaf; their int8 chunks are the
same here, where every leaf of a layer is a whole number of chunks.  Serving is held to a full
forward of the reference over the tokens so far (``ATOL`` of
``tests/test_torch_models.py``).
"""

import math
import os
import pickle
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subproc import run_with_devices
from _torch_dist import LM_ARCH, LM_DECODE_STEPS, LM_LR, LM_S, World, lm_mesh_world, lm_tokens
from repro import configs as jconfigs
from repro.dist import sharding as jsharding
from repro.models import transformer as jtf
from repro.optim import Adafactor as JAdafactor
from repro.optim import Adam as JAdam
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs, convert
from repro_torch.models import transformer as tf

ATOL = 1e-4           # the forward's rule against the reference (tests/test_torch_models.py)
OFF_GRID = 1e-3       # the share of a compressed step's components allowed one quantum off the reference's

COMPRESSED = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat, configs
from repro.optim import Adam
from repro.train.train_step import make_compressed_dp_step

path = sys.argv[1] if len(sys.argv) > 1 else {path!r}
with open(path, "rb") as f:
    tree, tok, lab, lr = pickle.load(f)
cfg = configs.get_smoke_config({arch!r})
params = jax.tree.map(jnp.asarray, tree)
mesh = compat.make_mesh((2, 2), ("pod", "data"))
opt = Adam(learning_rate=lr)
step, init_err = make_compressed_dp_step(cfg, opt, mesh, compress_axis="pod")
p, o, err, loss = step(params, opt.init(params), init_err(params), jnp.asarray(tok), jnp.asarray(lab))
host = lambda t: jax.tree.map(np.asarray, t)
with open(path + ".out", "wb") as f:
    pickle.dump(dict(params=host(p), m=host(o["m"]), err=host(err), loss=float(loss)), f)
print("COMPRESSED_OK")
"""


class _AxisSizes:
    """What the reference's rules read of a mesh: its axis sizes."""

    shape = {"data": 2, "model": 2}


def _axes(spec):
    """A spec's axes a dim, as tuples (a PartitionSpec writes a single axis as its name)."""
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]


def _port_tree(tree, cfg):
    """A JAX parameter-shaped tree (numpy leaves) as the port's name -> tensor dict."""
    return dict(convert.lm_params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu").named_parameters())


def _jax_reference(tree, tmp):
    """The JAX package's steps on the world's weights and tokens: the compressed step in a 4-device subprocess,
    beside the unsharded Adam and Adafactor steps and the forwards in this process."""
    jcfg, cfg = jconfigs.get_smoke_config(LM_ARCH), configs.get_smoke_config(LM_ARCH)
    tok, lab, dec = (a.astype(np.int32) for a in lm_tokens(cfg.vocab_size))
    path = os.path.join(tmp, "compressed.pkl")
    with open(path, "wb") as f:
        pickle.dump((tree, tok, lab, LM_LR), f)
    with ThreadPoolExecutor(1) as pool:
        sub = pool.submit(run_with_devices, COMPRESSED.format(path=path, arch=LM_ARCH), 4, 300)
        params = jax.tree.map(jnp.asarray, tree)
        out = {}
        jopt = JAdam(learning_rate=LM_LR)
        jp, jo, jl = jmake_train_step(jcfg, jopt, donate=False)[0](params, jopt.init(params), tok, lab)
        jg = jax.grad(jtf.loss_fn)(params, jcfg, jnp.asarray(tok), jnp.asarray(lab))
        out["grads"] = _port_tree(jg, cfg)
        out["adam"] = dict(params=_port_tree(jp, cfg), m=_port_tree(jo["m"], cfg), loss=float(jl))
        # Adafactor reads whole leaves: the reference optimizer on the port's per-layer tree
        flat = {n: jnp.asarray(t.numpy()) for n, t in _port_tree(tree, cfg).items()}
        jopt = JAdafactor(learning_rate=LM_LR, min_dim_size_to_factor=16)
        new, state = jopt.update({n: jnp.asarray(t.numpy()) for n, t in out["grads"].items()}, jopt.init(flat), flat)
        out["adafactor"] = dict(params={n: torch.from_numpy(np.array(p)) for n, p in new.items()},
                                v={n: {k: torch.from_numpy(np.array(t)) for k, t in v.items()}
                                   for n, v in state["v"].items()})
        seq = np.concatenate([tok, dec], axis=1)
        out["serve"] = [np.asarray(jtf.prefill_fn(params, jcfg, jnp.asarray(seq[:, :LM_S + i]))[0])
                        for i in range(LM_DECODE_STEPS + 1)]
        assert "COMPRESSED_OK" in sub.result()
    with open(path + ".out", "rb") as f:
        got = pickle.load(f)
    out["compressed"] = dict(loss=got["loss"], **{k: _port_tree(got[k], cfg) for k in ("params", "m", "err")})
    return out


@pytest.fixture(scope="module")
def results():
    """(every rank's results, the JAX package's)."""
    tree = jax.tree.map(np.asarray, jtf.init_model(jax.random.PRNGKey(0), jconfigs.get_smoke_config(LM_ARCH)))
    with tempfile.TemporaryDirectory() as ckpt, tempfile.TemporaryDirectory() as tmp:
        world = World(lm_mesh_world, 4, ckpt, tree, timeout=300)
        try:
            ref = _jax_reference(tree, tmp)
        except BaseException:
            world.kill()
            raise
        yield world.join(), ref


@pytest.fixture(scope="module")
def ranks(results):
    return results[0]


def _hold_step(got, want, grad, bound):
    """Within 1e-5 where the reference's gradient is resolved (|g| > 1e-4 max |g|); within twice the step's bound
    elsewhere, where a first step's sign is the rounding's (tests/test_torch_lm_train.py)."""
    resolved = grad.abs() > 1e-4 * grad.abs().max()
    diff = (got - want).abs()
    assert float(torch.where(resolved, diff, 0.0).max()) <= 1e-5
    assert bool(torch.where(resolved, True, diff <= 2 * bound + 1e-5).all())


def _hold_on_grid(got, want, tol, quantum, name):
    """Within ``tol`` but at most OFF_GRID of the components, and those within ``quantum``: a value on a
    boundary of the int8 grid may quantize one step away."""
    diff = (got - want).abs()
    off = diff > tol
    assert int(off.sum()) <= OFF_GRID * diff.numel(), (name, int(off.sum()), diff.numel())
    assert bool((diff[off] <= quantum + 1e-6).all()), (name, float(diff.max()))


@pytest.mark.parametrize("opt", ["adam", "adafactor"])
def test_sharded_step_equals_unsharded(ranks, opt):
    for r in ranks:
        l1, l2 = r[f"{opt}.loss"]
        assert abs(l1 - l2) <= 1e-5 * abs(l1)
        assert r[f"{opt}.params"] <= 1e-5 and r[f"{opt}.state"] <= 1e-5


@pytest.mark.parametrize("opt", ["adam", "adafactor"])
def test_sharded_step_matches_jax(results, opt):
    ranks, ref = results
    got = ranks[0][f"{opt}.full"]
    assert abs(got["loss"] - ref["adam"]["loss"]) <= 1e-5 * abs(ref["adam"]["loss"])
    assert set(got["params"]) == set(ref[opt]["params"])
    for name, p in got["params"].items():
        _hold_step(p, ref[opt]["params"][name], ref["grads"][name], LM_LR)
    if opt == "adam":
        for name, m in got["state"]["m"].items():
            want = ref["adam"]["m"][name]
            assert (m - want).abs().max() <= 1e-5 * want.abs().max() + 1e-9, name
    else:
        for name, v in got["state"]["v"].items():
            for key, t in v.items():
                want = ref["adafactor"]["v"][name][key]
                assert t.shape == want.shape and (t - want).abs().max() <= 1e-4 * want.abs().max(), (name, key)


def test_specs_are_the_references(ranks):
    for r in ranks:
        for name, (shape, spec) in r["specs"].items():
            assert spec == tuple(jsharding._leaf_spec(shape, _AxisSizes())), name
        assert _axes(r["input_spec"]) == _axes(jsharding.batch_spec(_AxisSizes(), 4, None))
        assert r["input_spec"] == (("data",), None)
    assert any(len([e for e in spec if e]) == 2 for _, spec in ranks[0]["specs"].values())  # FSDP and TP both cut


def test_each_rank_holds_its_blocks(ranks):
    model = tf.Transformer(configs.get_smoke_config(LM_ARCH), device="meta")
    full = sum(p.numel() * 4 for p in model.parameters())
    want = 0
    for name, (shape, spec) in ranks[0]["specs"].items():
        parts = math.prod(2 for e in spec if e)
        assert ranks[0]["block_shapes"][name] == tuple(s // (2 if e else 1) for s, e in zip(shape, spec))
        want += math.prod(shape) * 4 // parts
    for r in ranks:
        params_bytes, state_bytes = r["adam.bytes"]
        assert params_bytes == want < full
        assert state_bytes == 2 * want + 4  # m and v by the same rule, and the int32 step
        assert r["opt_specs"]["m"] == {n: s for n, (_, s) in r["specs"].items()}


def test_compressed_dp_step_matches_uncompressed(ranks):
    for r in ranks:
        l1, l2, dp, err = r["compressed"]
        assert abs(l1 - l2) < 1e-2 and dp < 5e-2 and err > 0.0
        # the first moments carry the averaged gradient: the int8 mean's error is a few quanta of 1/127 of a
        # chunk's largest; a pod's gradient alone (no exchange over "pod") is off by the order of the moments
        assert r["compressed.m_err"] < 2e-2
    assert len({r["compressed"][:3] for r in ranks}) == 1  # the parameters stay replicated
    assert all(torch.equal(r["compressed.digest"], ranks[0]["compressed.digest"]) for r in ranks)


def test_compressed_dp_step_matches_jax(results):
    ranks, ref = results
    got, want = ranks[0]["compressed.full"], ref["compressed"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for name, p in got["params"].items():
        _hold_on_grid(p, want["params"][name], 1e-5, 2 * LM_LR, name)
    for key in ("m", "err"):
        for name, t in got[key].items():
            w, g = want[key][name], float(ref["grads"][name].abs().max())
            # a buffer is the gradient's residual and carries the gradient's rounding: 1e-5 of its largest
            # component; one int8 step of a chunk is at most 1/127 of a pod's largest
            _hold_on_grid(t, w, 1e-5 * g, 2 * g / 127, (key, name))


def test_sharded_serving_equals_unsharded(ranks):
    for r in ranks:
        assert len(r["serve.diffs"]) == 5 and max(r["serve.diffs"]) <= 1e-5
        assert r["serve.cache_rows"] == 2 and r["donate_cache_false_keeps"]
        assert all(spec[0] == ("data",) for spec in r["serve.cache_specs"])


def test_sharded_recurrent_serving_equals_unsharded(ranks):
    """recurrentgemma's smoke model: the rglru states {"h", "conv"} and the local rings take the batch's rows."""
    for r in ranks:
        assert len(r["recurrent.diffs"]) == 5 and max(r["recurrent.diffs"]) <= 1e-5
        assert all(rows == {k: 2 for k in rows} for rows in r["recurrent.cache_rows"])
        specs = r["recurrent.cache_specs"]
        assert {frozenset(s) for s in specs} == {frozenset({"h", "conv"}), frozenset({"k", "v"})}
        assert all(spec[0] == ("data",) for s in specs for spec in s.values())


def test_sharded_moe_serving_equals_unsharded(ranks):
    """qwen3-moe's smoke model: a group of 64 prefill tokens (and of a decode step's 4) holds both data ranks' 32
    (2) rows, and drops happen; each rank all-gathers its routing counts once a MoE layer and call."""
    for r in ranks:
        assert len(r["moe.diffs"]) == 5 and max(r["moe.diffs"]) <= 1e-5
        assert sum(r["moe.dropped"]) > 0
        group, rows = r["moe.group_and_rows"]
        assert group > rows and group % rows == 0
        assert r["moe.collective_calls"] >= 2 * 5  # the routing exchange of both layers in each of the 5 calls


def test_sharded_embeddings_step_equals_unsharded(ranks):
    """llava's smoke model, one Adam step on (B, S, d) embeddings: the inputs' spec cuts the batch alone."""
    for r in ranks:
        l1, l2 = r["embed.loss"]
        assert abs(l1 - l2) <= 1e-5 * abs(l1)
        assert r["embed.params"] <= 1e-5 and r["embed.state"] <= 1e-5
        assert r["embed.input_spec"] == (("data",), None, None)


def test_sharded_serving_matches_jax(results):
    ranks, ref = results
    served = ranks[0]["serve.logits"]
    assert len(served) == len(ref["serve"]) == LM_DECODE_STEPS + 1
    for got, want in zip(served, ref["serve"]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_checkpoint_restores_across_meshes(ranks):
    assert all(r["ckpt.unsharded_bitwise"] and r["ckpt.sharded_bitwise"] for r in ranks)
