"""The port's checkpoints: the seven cases of ``tests/test_ckpt.py``, bf16 leaves, and a JAX checkpoint.

A float32 checkpoint written by the JAX package's ``CheckpointManager``
(an olmo smoke model and its Adam state after one step) restores into the
port through ``convert`` bitwise (within 0); the layout on disk is the
reference's (``step_XXXXXXXXXX`` directories, ``manifest.json``, one
``.npy`` a leaf).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.models import transformer as jtf
from repro.optim import Adafactor as JAdafactor
from repro.optim import Adam as JAdam
from repro.train.train_step import make_train_step as jmake_train_step
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs, convert
from repro_torch.ckpt import CheckpointManager
from repro_torch.optim import Adafactor, Adam


def _state(x=1.0):
    return {
        "params": {"w": torch.full((4, 4), x), "b": torch.arange(3.0)},
        "opt": {"m": {"w": torch.zeros(4, 4), "b": torch.zeros(3)}, "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _state(3.5))
    step, restored = mgr.restore(_state(0.0))
    assert step == 10
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 3.5))
    assert int(restored["opt"]["step"]) == 7 and restored["opt"]["step"].dtype == torch.int32


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]
    _, restored = mgr.restore(_state())
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 4.0))


def test_no_tmp_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state())
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    manifest = json.load(open(tmp_path / "step_0000000005" / "manifest.json"))
    assert [e["path"] for e in manifest["leaves"]] == ["opt.m.b", "opt.m.w", "opt.step", "params.b", "params.w"]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    with pytest.raises((ValueError, KeyError)):
        mgr.restore({"other": torch.zeros(2)})


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros(5, 5)
    with pytest.raises(ValueError):
        mgr.restore(bad)


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _state(float(s)))
    step, restored = mgr.restore(_state(), step=2)
    assert step == 2
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 2.0))


def test_bf16_leaves_and_modules_round_trip(tmp_path):
    cfg = configs.get_smoke_config("gemma2-2b")
    from repro_torch.models import transformer as ttf

    model = ttf.init_model(cfg, 0, device="cpu").to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": model, "x": torch.randn(5, dtype=torch.float64)})
    manifest = json.load(open(tmp_path / "step_0000000003" / "manifest.json"))
    assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16", "float64"}
    target = ttf.init_model(cfg, 1, device="cpu").to(torch.bfloat16)
    step, state = mgr.restore({"params": target, "x": torch.zeros(5, dtype=torch.float64)})
    assert step == 3 and state["params"] is target
    assert all(torch.equal(p, q) for p, q in zip(target.parameters(), model.parameters()))


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_jax_checkpoint_restores_through_convert(tmp_path, optimizer):
    jcfg = jconfigs.get_smoke_config("olmo-1b")
    cfg = configs.get_smoke_config("olmo-1b")
    params = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    jopt = JAdam(learning_rate=1e-3) if optimizer == "adam" else JAdafactor(learning_rate=1e-3)
    opt = Adam(learning_rate=1e-3) if optimizer == "adam" else Adafactor(learning_rate=1e-3)
    rng = np.random.default_rng(0)
    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    step_fn, _ = jmake_train_step(jcfg, jopt, donate=False)
    params, opt_state, _ = step_fn(params, jopt.init(params), tok, tok)
    JCheckpointManager(str(tmp_path)).save(1, {"params": params, "opt": opt_state})

    step, tree = CheckpointManager(str(tmp_path)).read()
    assert step == 1
    model = convert.lm_params_from_numpy(tree["params"], cfg, "cpu")
    state = convert.lm_opt_state_from_numpy(tree["opt"], model, opt)
    want = dict(convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu").named_parameters())
    assert all(torch.equal(p, want[n]) for n, p in model.named_parameters())
    assert int(state["step"]) == 1 and set(state) == set(opt.init(model))
    # every second moment, bitwise the reference's: a layer's is its stacked leaf's cycle l // len(pattern)
    plen = len(cfg.pattern)
    for name, moments in state["v"].items():
        keys = name.split(".")
        if keys[0] == "layers":
            l = int(keys[1])
            leaf, index = _walk(opt_state["v"]["groups"][l % plen], keys[2:]), l // plen
        else:
            leaf, index = _walk(opt_state["v"], keys), None
        for key, t in (moments.items() if isinstance(moments, dict) else [(None, moments)]):
            src = np.asarray(leaf[key] if key else leaf)
            assert np.array_equal(t.numpy(), src if index is None else src[index]), (name, key)

def _walk(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree
