"""The port's five examples (``examples_torch/``) against the JAX package's public API on the CPU.

Each example's functions run with ``device="cpu"`` at a small size; the
same numpy inputs go through the JAX package:

- quickstart and gp_system_identification: the mean and variance before
  training at ``tests/test_torch_predict.py``'s atol 1e-3; quickstart's
  parameters after 5 ``optimize`` steps within rtol 2e-2 (the training
  rule of ``chip_smoke.py``'s ``train`` phase);
- serve_gp: each mode's served predictions against the JAX
  ``predict_from_state`` / ``predict_from_state_batched`` (the online mode
  replays its arrivals in JAX; the ragged mode's results against a JAX
  ``GPFleet`` on the port fleet's final data) at atol 1e-3, each bitwise
  equal to a synchronous ``predict`` of the port's own state, and the
  ragged mode's request and wave counts equal to the JAX example's;
- composite_workload: the telemetry counters equal to the reference's
  loop's, by name and count, but for the training program, which the
  reference counts once at its trace (``executor.traces.*``) and the port
  at each eager step;
- train_lm at the smoke size: 3 steps' losses equal to the JAX trainer's
  from the same weights within ``tests/test_torch_lm_train.py``'s 1e-5
  relative; the command line killed after a checkpoint and rerun resumes
  from the last saved step, with the uninterrupted run's losses within
  1e-5 relative (PERF.md's resume rule; one thread a process, beside the
  other test workers: ``_torch_threads``).

Without a card every example's default ``device="cuda"`` raises.
"""

import importlib.util
import io
import contextlib
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro import configs as jconfigs
from repro.core import GaussianProcess as JGP
from repro.core import GPBatch as JGPBatch
from repro.core import GPFleet as JGPFleet
from repro.core import Matern52 as JMatern52
from repro.core import Scaled as JScaled
from repro.core import Sum as JSum
from repro.core import White as JWhite
from repro.core import predict as jpred
from repro.data import msd as jmsd
from repro.data.synthetic import token_batches as jtoken_batches
from repro.models import transformer as jtf
from repro.optim import Adam as JAdam
from repro.optim import cosine_warmup as jcosine_warmup
from repro.train.train_step import make_train_step as jmake_train_step
from repro.train.trainer import Trainer as JTrainer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from _torch_threads import one_torch_thread  # noqa: F401, E402
import repro_torch.obs as obs  # noqa: E402
from examples_torch import composite_workload, gp_system_identification, quickstart, serve_gp, train_lm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Matern52, Scaled, Sum, White  # noqa: E402
from repro_torch.core import predict as pred  # noqa: E402
from repro_torch.core.gp import ieee_float32_matmul  # noqa: E402

CPU = "cpu"
ATOL = 1e-3          # tests/test_torch_predict.py: a prediction against its JAX reference
PARAM_RTOL = 2e-2    # trained hyperparameters (chip_smoke.py's train phase: its parameter rule)
LOSS_RTOL = 1e-5     # tests/test_torch_lm_train.py: a loss against the reference's; also the resume rule
QUIET = dict(log=lambda *a: None)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(autouse=True)
def _obs_off():
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()


# -- quickstart --------------------------------------------------------------

QS = dict(n=64, n_test=20, tile=16, steps=5, lr=0.1, n_big=512, tile_big=64, m_inducing=32)


def test_quickstart_matches_the_reference():
    out = quickstart.run(CPU, **QS, **QUIET)
    d = quickstart.make_data(QS["n"], QS["n_test"], QS["n_big"])
    jgp = JGP(d["x_train"], d["y_train"], tile_size=QS["tile"])
    mean, var = jgp.predict_with_uncertainty(d["x_test"])
    np.testing.assert_allclose(_np(out["mean"]), np.asarray(mean), atol=ATOL)
    np.testing.assert_allclose(_np(out["var"]), np.asarray(var), atol=ATOL)
    jgp.optimize(steps=QS["steps"], lr=QS["lr"])
    got = [float(v) for v in (out["params"].lengthscale, out["params"].vertical, out["params"].noise)]
    want = [float(v) for v in (jgp.params.lengthscale, jgp.params.vertical, jgp.params.noise)]
    np.testing.assert_allclose(got, want, rtol=PARAM_RTOL)
    assert out["mae"] == pytest.approx(float(np.abs(np.asarray(mean) - np.sin(d["x_test"][:, 0])).mean()), abs=ATOL)
    assert np.isfinite(_np(out["mean_lowrank"])).all() and out["mae_lowrank"] < 0.1


# -- gp_system_identification -------------------------------------------------


def test_gp_system_identification_matches_the_reference():
    n, n_test, tile = 96, 24, 32
    out = gp_system_identification.run(CPU, n=n, n_test=n_test, tile=tile, **QUIET)
    x_tr, y_tr, x_te, y_te = jmsd.make_dataset(n, n_test, jmsd.MSDConfig(), seed=0)
    mean, var = JGP(x_tr, y_tr, tile_size=tile).predict_with_uncertainty(x_te)
    np.testing.assert_allclose(_np(out["mean"]), np.asarray(mean), atol=ATOL)
    np.testing.assert_allclose(_np(out["var"]), np.asarray(var), atol=ATOL)
    np.testing.assert_allclose(_np(out["mean_monolithic"]), np.asarray(mean), atol=ATOL)
    assert out["max_tiled_vs_monolithic"] <= ATOL and 0.0 < out["coverage"] <= 1.0


# -- serve_gp ------------------------------------------------------------------

SERVE = dict(n=64, tile=16, batch=16, batches=3)


def _serve_data(n, seed=0):
    x_tr, y_tr, _, _ = jmsd.make_dataset(n, 1, jmsd.MSDConfig(), seed=seed)
    return x_tr, y_tr


def test_serve_single_matches_the_reference():
    out = serve_gp.run(CPU, **SERVE, **QUIET)
    jgp = JGP(*_serve_data(SERVE["n"]), tile_size=SERVE["tile"])
    jgp.predict(out["probe"])
    want = jpred.predict_from_state(jgp.posterior(), out["probe"])
    np.testing.assert_allclose(_np(out["served"]), np.asarray(want), atol=ATOL)
    assert torch.equal(out["served"], out["gp"].predict(out["probe"]))
    assert out["p99_ms"] >= out["p50_ms"] > 0 and len(out["latencies_s"]) == SERVE["batches"]


def test_serve_fleet_matches_the_reference():
    b = 3
    out = serve_gp.run(CPU, fleet=b, **SERVE, **QUIET)
    xs, ys = zip(*(_serve_data(SERVE["n"], seed=i) for i in range(b)))
    jfleet = JGPBatch(np.stack(xs), np.stack(ys), tile_size=SERVE["tile"])
    jfleet.predict(out["probe"])
    stacked = np.broadcast_to(out["probe"], (b,) + out["probe"].shape)
    want = jpred.predict_from_state_batched(jfleet.posterior(), stacked)
    np.testing.assert_allclose(_np(out["served"]), np.asarray(want), atol=ATOL)
    assert torch.equal(out["served"], out["fleet"].predict(out["probe"]))


def test_serve_online_matches_the_reference():
    """Two batches: the second is served after one absorbed arrival, replayed in JAX."""
    arrive, cfg = 8, jmsd.MSDConfig()
    kw = dict(SERVE, batches=2)
    out = serve_gp.run(CPU, online=True, arrive=arrive, **kw, **QUIET)
    jgp = JGP(*_serve_data(kw["n"]), tile_size=kw["tile"], sliding_window=kw["n"])
    jgp.predict(next(serve_gp.request_batches(cfg, kw["batch"], 1)))
    u, yv = jmsd.simulate(arrive + cfg.n_regressors - 1, cfg, seed=1000)
    x_new, y_new = jmsd.nfir_features(u, yv, cfg.n_regressors)
    jgp.update(x_new.astype(np.float32), y_new.astype(np.float32))
    np.testing.assert_allclose(_np(out["served"]), np.asarray(jgp.predict(out["probe"])), atol=ATOL)
    gp = out["gp"]
    with ieee_float32_matmul(gp.device):
        assert torch.equal(gp.predict(out["probe"]), pred.predict_from_state(gp.posterior(), out["probe"]))
    assert out["window"] <= kw["n"] and out["refit_ms"] > 0


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_ragged_counts_and_results_match_the_reference(tmp_path):
    import argparse

    b, arrive = 4, 8
    kw = dict(n=32, tile=16, batch=16, batches=3)
    path = tmp_path / "metrics.jsonl"
    out = serve_gp.run(CPU, ragged=b, arrive=arrive, metrics=str(path), **kw, **QUIET)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _jax_example("serve_gp").serve_ragged(argparse.Namespace(ragged=b, arrive=arrive, **kw), jmsd.MSDConfig())
    served = re.search(r"served (\d+) requests in (\d+) waves", buf.getvalue())
    assert (out["requests"], out["waves"]) == (int(served[1]), int(served[2]))
    final = re.search(r"final sizes (\d+)\.\.(\d+)", buf.getvalue())
    assert (min(out["sizes"]), max(out["sizes"])) == (int(final[1]), int(final[2]))
    # the last wave's results: against a JAX fleet on the port fleet's final data, and bitwise a synchronous call
    fleet = out["fleet"]
    xs, ys = [_np(x) for x in fleet._xs], [_np(y) for y in fleet._ys]
    tests = [out["probe"][i] for i in range(b)]
    want = JGPFleet(xs, ys, tile_size=kw["tile"]).predict_each(tests)
    again = fleet.predict_each(tests)
    for i in range(b):
        np.testing.assert_allclose(_np(out["served"][i]), np.asarray(want[i]), atol=ATOL)
        assert torch.equal(out["served"][i], again[i].cpu())
    events = path.read_text().splitlines()
    assert out["events"] >= len(events) > 0 and '"obs.cache_stats"' in events[-1]


# -- composite_workload --------------------------------------------------------

CW = dict(n=48, n_test=20, tile=16, lr=0.1, rounds=3, arrive=8)


def _jax_composite(steps):
    """The reference script's loop through the JAX package, at CW's sizes: (counters, params, final mean)."""
    f = composite_workload.f
    jobs.reset()
    jobs.enable()
    rng = np.random.default_rng(0)
    x_train = rng.uniform(-1, 1, (CW["n"], 2)).astype(np.float32)
    y_train = (f(x_train) + 0.05 * rng.standard_normal(CW["n"])).astype(np.float32)
    x_test = rng.uniform(-1, 1, (CW["n_test"], 2)).astype(np.float32)
    gp = JGP(x_train, y_train, tile_size=CW["tile"], kernel=JSum(JScaled(JMatern52()), JWhite()))
    gp.predict_with_uncertainty(x_test)
    gp.optimize(steps=steps, lr=CW["lr"])
    gp.predict_with_uncertainty(x_test)
    for _ in range(CW["rounds"]):
        x_new = rng.uniform(-1, 1, (CW["arrive"], 2)).astype(np.float32)
        y_new = (f(x_new) + 0.05 * rng.standard_normal(CW["arrive"])).astype(np.float32)
        gp.update(x_new, y_new)
        mean, _ = gp.predict_with_uncertainty(x_test)
    counters = dict(jobs.snapshot()["counters"])
    jobs.disable()
    return counters, gp.params, np.asarray(mean)


def test_composite_workload_counts_as_the_reference():
    steps = 3
    out = composite_workload.run(CPU, steps=steps, **CW, **QUIET)
    want, jparams, jmean = _jax_composite(steps)
    want = {k: v for k, v in want.items() if not k.startswith("executor.traces.")}
    # one training program's counters, as the port counts each of its eager steps
    obs.reset()
    obs.enable()
    out_params = out["params"]
    pred.nlml_program_env(np.zeros((CW["n"], 2), np.float32), np.zeros(CW["n"], np.float32), out_params, CW["tile"],
                          kernel=Sum(Scaled(Matern52()), White()), device=CPU)
    one = dict(obs.snapshot()["counters"])
    assert set(out["counters"]) == set(want)
    assert out["counters"] == {k: v + steps * one.get(k, 0.0) for k, v in want.items()}
    assert out["warm"] == 3 and out["cold"] == 2 and out["health"] == 0
    np.testing.assert_allclose(_np(out["mean_final"]), jmean, atol=ATOL)
    got = [float(v) for v in (out_params[0].scale, out_params[0].inner.lengthscale, out_params[1].noise)]
    ref = [float(v) for v in (jparams[0].scale, jparams[0].inner.lengthscale, jparams[1].noise)]
    np.testing.assert_allclose(got, ref, rtol=PARAM_RTOL)
    assert set(out["cache_stats"]) <= set(obs.cache_stats())


# -- train_lm ------------------------------------------------------------------


def test_train_lm_losses_match_the_jax_trainer():
    arch, steps, batch, seq, lr = "olmo-1b", 3, 2, 16, 3e-4
    jcfg = jconfigs.get_smoke_config(arch)
    params = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    opt = JAdam(learning_rate=jcosine_warmup(lr, steps // 10, steps))
    step_fn, _ = jmake_train_step(jcfg, opt, donate=False)

    def data_fn(step):
        t, l = next(jtoken_batches(jcfg.vocab_size, batch, seq, seed=step))
        return jax.numpy.asarray(t), jax.numpy.asarray(l)

    want = JTrainer(step_fn, params, opt.init(params), data_fn, log_every=0).run(steps).losses
    cfg = train_lm.build_config(arch, "smoke")
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, CPU)
    out = train_lm.train(cfg, steps=steps, batch=batch, seq=seq, lr=lr, params=model, device=CPU, **QUIET)
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
    assert out["steps"] == steps and out["resumed_from"] is None


def test_train_lm_killed_and_rerun_resumes_as_an_uninterrupted_run(tmp_path):
    """The command line, killed after its log line at step 10 (checkpoints every 4), then rerun."""
    ck = str(tmp_path / "ck")
    args = ["--arch", "qwen1.5-0.5b", "--steps", "12", "--batch", "2", "--seq", "16", "--ckpt-every", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-u", str(ROOT / "examples_torch" / "train_lm.py"), *args,
                             "--ckpt-dir", ck, "--device", CPU], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    deadline, killed = time.time() + 240, False
    for line in proc.stdout:
        if line.startswith("[trainer] step 10/"):
            proc.send_signal(signal.SIGKILL)
            killed = True
            break
        if time.time() > deadline:
            break
    proc.kill()
    proc.wait(timeout=60)
    assert killed, "the run ended before its log line at step 10"
    from repro_torch.ckpt import CheckpointManager

    saved = CheckpointManager(ck).latest_step()
    assert saved in (4, 8)
    kw = dict(steps=12, batch=2, seq=16, device=CPU, **QUIET)
    again = train_lm.run("qwen1.5-0.5b", "smoke", ckpt_dir=ck, ckpt_every=4, **kw)
    whole = train_lm.run("qwen1.5-0.5b", "smoke", **kw)
    assert again["resumed_from"] == saved and again["steps"] == saved + 12
    np.testing.assert_allclose(again["losses"][: 12 - saved], whole["losses"][saved:], rtol=LOSS_RTOL)


# -- the default device --------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the no-card behaviour")
@pytest.mark.parametrize("example", ["quickstart", "gp_system_identification", "serve_gp", "composite_workload",
                                     "train_lm"])
def test_default_device_is_cuda_and_raises_without_a_card(example):
    mod = {"quickstart": quickstart, "gp_system_identification": gp_system_identification, "serve_gp": serve_gp,
           "composite_workload": composite_workload, "train_lm": train_lm}[example]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run(log=lambda *a: None)
