"""The port's trainer under faults: kill a run mid-flight and resume, stragglers, data determinism.

The cases of ``tests/test_trainer_fault.py`` on the port (a qwen1.5 smoke
model on the CPU; the killed run in a subprocess that imports no JAX),
plus a resumed run's losses against an uninterrupted one's, in process:
data are seeded by the step's index and every op here is deterministic, so
that they are equal bitwise.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np

from _subproc import SRC
from _torch_threads import one_torch_thread  # noqa: F401

SCRIPT = r"""
import sys, torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.data.synthetic import token_batches
from repro_torch.models import transformer as tf
from repro_torch.optim import Adam
from repro_torch.train import make_train_step
from repro_torch.train.trainer import Trainer

ckdir, steps, every = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = configs.get_smoke_config("qwen1.5-0.5b")
model = tf.init_model(cfg, 0, device="cpu")
opt = Adam(learning_rate=1e-3)
step_fn, _ = make_train_step(cfg, opt)

def data_fn(step):
    t, l = next(token_batches(cfg.vocab_size, 4, 16, seed=step))
    return torch.from_numpy(t), torch.from_numpy(l)

tr = Trainer(step_fn, model, opt.init(model), data_fn, ckpt_dir=ckdir or None, ckpt_every=every,
             ckpt_async=False, log_every=0)
print(f"RESUMED_FROM={tr.report.resumed_from}", flush=True)
rep = tr.run(steps)
print("LOSSES=" + ",".join(repr(x) for x in rep.losses), flush=True)
print(f"FINAL_STEP={rep.steps} LOSS={rep.last_loss:.4f}", flush=True)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(ck, steps, every=5):
    out = subprocess.run([sys.executable, "-c", SCRIPT, ck, str(steps), str(every)], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(line.split("=", 1) for line in out.stdout.splitlines() if line.startswith(("RESUMED", "LOSSES")))
    return lines["RESUMED_FROM"], [float(x) for x in lines["LOSSES"].split(",")], out.stdout


def test_kill_and_resume(tmp_path):
    ck = str(tmp_path / "ck")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, ck, "400", "5"], env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 300
    killed = False
    while time.time() < deadline:
        if os.path.isdir(ck) and any(d.startswith("step_") for d in os.listdir(ck)):
            time.sleep(0.3)
            proc.send_signal(signal.SIGKILL)
            killed = True
            break
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    proc.wait(timeout=60)
    assert killed, "run finished before a checkpoint appeared: lower ckpt_every"
    resumed, losses, out = _run(ck, 10)
    assert resumed != "None", out
    step = int(resumed)
    assert step >= 5 and len(losses) == 10
    final = [line for line in out.splitlines() if line.startswith("FINAL_STEP=")]
    assert final and int(final[0].split()[0].split("=")[1]) == step + 10


def test_resumed_losses_equal_an_uninterrupted_run(tmp_path):
    """Data determinism across restarts: steps 3-5 after a resume from step 3 are the uninterrupted run's."""
    import torch

    from repro_torch import configs
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Adam
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import Trainer

    cfg = configs.get_smoke_config("qwen1.5-0.5b")
    opt = Adam(learning_rate=1e-3)
    step_fn, _ = make_train_step(cfg, opt)

    def data_fn(step):
        t, l = next(token_batches(cfg.vocab_size, 4, 16, seed=step))
        return torch.from_numpy(t), torch.from_numpy(l)

    def trainer(seed, ckpt=None):
        model = tf.init_model(cfg, seed, device="cpu")
        return Trainer(step_fn, model, opt.init(model), data_fn, ckpt_dir=ckpt, ckpt_every=3, log_every=0,
                       log_fn=lambda msg: None)

    whole = trainer(0).run(6).losses
    ck = str(tmp_path / "ck")
    first = trainer(0, ck).run(3).losses
    again = trainer(1, ck)  # other weights: the checkpoint replaces them
    assert again.report.resumed_from == 3 and first == whole[:3]
    np.testing.assert_array_equal(again.run(3).losses, whole[3:])


def test_straggler_detection():
    from repro_torch.train.trainer import Trainer

    calls = {"n": 0}

    def slow_step(params, opt, x, y):
        calls["n"] += 1
        if calls["n"] == 12:
            time.sleep(0.3)  # injected straggler
        return params, opt, 1.0

    rep = Trainer(slow_step, {}, {}, lambda s: (None, None), straggler_factor=3.0, log_every=0).run(20)
    assert rep.stragglers >= 1 and rep.steps == 20 and rep.resumed_from is None
