"""Port parity: the prediction pipeline and ``GaussianProcess`` end to end.

The port runs on CPU tensors (``device="cpu"``: the kernels' plain
versions); the reference is the JAX package's ``GaussianProcess`` with
``op_backend="pallas"`` (Pallas kernels in interpret mode), fed the same
numpy inputs.  Tolerances are the JAX package's own (``tests/test_predict.py``:
atol 1e-3 against its reference; fused against staged at rtol 1e-4).
"""

import numpy as np
import pytest
import torch

from repro.core import GaussianProcess as JaxGP
from repro_torch import convert
from repro_torch.core import GaussianProcess, SEKernelParams
from repro_torch.core import predict as pred

CPU = "cpu"
M = 16


@pytest.fixture(scope="module")
def case():
    """n=48 training rows (3 tiles), n̂=20 test rows (2 tiles, padded), D=3."""
    rng = np.random.default_rng(0)
    n, nt, d = 48, 20, 3
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sin(x.sum(-1)).astype(np.float32) + 0.1 * rng.standard_normal(n).astype(np.float32)
    xt = rng.standard_normal((nt, d)).astype(np.float32)
    gp = JaxGP(x, y, tile_size=M, op_backend="pallas")
    mean_c, cov_c = gp.predict_full_cov(xt)           # cold: the fused program
    mean_w = gp.predict(xt)                           # warm: the cached factor
    _, var_w = gp.predict_with_uncertainty(xt)
    st = gp.posterior()
    state = {
        "lpacked": np.asarray(st.lpacked), "alpha": np.asarray(st.alpha),
        "x_chunks": np.asarray(st.x_chunks), "beta": np.asarray(st.beta),
        "y_chunks": np.asarray(st.y_chunks), "n": st.n, "m": st.m,
        "params": [np.asarray(v) for v in (st.params.lengthscale, st.params.vertical, st.params.noise)],
    }
    return dict(
        x=x, y=y, xt=xt, mean=np.asarray(mean_c), cov=np.asarray(cov_c),
        mean_warm=np.asarray(mean_w), var=np.asarray(var_w), state=state,
    )


def test_gp_predict_calls_match_pallas_reference(case):
    gp = GaussianProcess(case["x"], case["y"], tile_size=M, device=CPU)
    np.testing.assert_allclose(gp.predict(case["xt"]).numpy(), case["mean"], atol=1e-3)
    gp = GaussianProcess(case["x"], case["y"], tile_size=M, device=CPU)
    mean, var = gp.predict_with_uncertainty(case["xt"])
    np.testing.assert_allclose(mean.numpy(), case["mean"], atol=1e-3)
    np.testing.assert_allclose(var.numpy(), case["var"], atol=1e-3)
    gp = GaussianProcess(case["x"], case["y"], tile_size=M, device=CPU)
    mean, cov = gp.predict_full_cov(case["xt"])
    assert cov.shape == (20, 20) and mean.shape == (20,)
    np.testing.assert_allclose(mean.numpy(), case["mean"], atol=1e-3)
    np.testing.assert_allclose(cov.numpy(), case["cov"], atol=1e-3)


def test_warm_posterior_cache_path(case):
    gp = GaussianProcess(case["x"], case["y"], tile_size=M, device=CPU)
    cold = gp.predict(case["xt"])
    state = gp._posterior
    assert state is not None and gp._cache_warm()
    warm = gp.predict(case["xt"])
    assert gp._posterior is state  # the factor was reused, not rebuilt
    np.testing.assert_allclose(warm.numpy(), case["mean_warm"], atol=1e-3)
    np.testing.assert_allclose(warm.numpy(), cold.numpy(), rtol=1e-4, atol=1e-6)
    _, var = gp.predict_with_uncertainty(case["xt"])
    np.testing.assert_allclose(var.numpy(), case["var"], atol=1e-3)
    gp.params = SEKernelParams(2.0, 1.0, 0.1)  # new hyperparameters: a new factor
    gp.predict(case["xt"])
    assert gp._posterior is not state
    gp.invalidate_cache()
    assert gp._posterior is None


def test_in_place_edit_of_training_data_invalidates_cache(case):
    gp = GaussianProcess(case["x"], case["y"], tile_size=M, device=CPU)
    gp.predict(case["xt"])
    state = gp._posterior
    gp.y_train.mul_(2.0)
    assert not gp._cache_warm()
    gp.predict(case["xt"])
    assert gp._posterior is not state


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("n_streams", [None, 2])
def test_fused_matches_staged(case, full_cov, n_streams):
    args = (case["x"], case["y"], case["xt"], SEKernelParams(), M)
    kw = dict(full_cov=full_cov, n_streams=n_streams, device=CPU)
    fused = pred.predict_fused(*args, **kw)
    staged = pred.predict_staged(*args, **kw)
    for f, s in zip(fused if full_cov else (fused,), staged if full_cov else (staged,)):
        np.testing.assert_allclose(f.numpy(), s.numpy(), rtol=1e-4, atol=1e-6)


def test_fused_state_matches_staged_state(case):
    args = (case["x"], case["y"], case["xt"], SEKernelParams(), M)
    _, fused = pred.predict_fused(*args, with_state=True, device=CPU)
    staged = pred.posterior_state(case["x"], case["y"], SEKernelParams(), M, device=CPU)
    for name in ("lpacked", "alpha", "beta", "y_chunks", "x_chunks"):
        np.testing.assert_allclose(
            getattr(fused, name).numpy(), getattr(staged, name).numpy(), rtol=1e-4, atol=1e-6
        )


def test_monolithic_pipeline(case):
    gp = GaussianProcess(case["x"], case["y"], pipeline="monolithic", device=CPU)
    mean, cov = gp.predict_full_cov(case["xt"])
    np.testing.assert_allclose(mean.numpy(), case["mean"], atol=1e-3)
    np.testing.assert_allclose(cov.numpy(), case["cov"], atol=1e-3)
    np.testing.assert_allclose(gp.predict(case["xt"]).numpy(), case["mean"], atol=1e-3)


def test_state_carried_over_from_jax_gives_the_same_mean(case):
    s = case["state"]
    params = convert.params_from_numpy(*s["params"])
    state = convert.posterior_state_from_numpy(
        s["lpacked"], s["alpha"], s["x_chunks"], s["n"], s["m"], params,
        s["beta"], s["y_chunks"], device=CPU,
    )
    mean = pred.predict_from_state(state, case["xt"])
    np.testing.assert_allclose(mean.numpy(), case["mean_warm"], atol=1e-5)
    _, cov = pred.predict_from_state(state, case["xt"], full_cov=True)
    np.testing.assert_allclose(cov.numpy(), case["cov"], atol=1e-4)
    with pytest.raises(ValueError):
        convert.posterior_state_from_numpy(
            s["lpacked"][:-1], s["alpha"], s["x_chunks"], s["n"], s["m"], params, device=CPU
        )


def test_padding_invariance(case):
    means = [
        pred.predict(case["x"], case["y"], case["xt"], SEKernelParams(), m, device=CPU).numpy()
        for m in (8, 16, 25, 48)
    ]
    for mu in means[1:]:
        np.testing.assert_allclose(mu, means[0], atol=2e-3)


def test_float64_flows_through(case):
    gp = GaussianProcess(case["x"], case["y"], tile_size=M, dtype=torch.float64, device=CPU)
    mean, var = gp.predict_with_uncertainty(case["xt"])
    assert mean.dtype == var.dtype == torch.float64
    mono = GaussianProcess(
        case["x"], case["y"], pipeline="monolithic", dtype=torch.float64, device=CPU
    ).predict_with_uncertainty(case["xt"])
    np.testing.assert_allclose(mean.numpy(), mono[0].numpy(), atol=1e-10)
    np.testing.assert_allclose(var.numpy(), mono[1].numpy(), atol=1e-10)


def test_input_validation(case):
    with pytest.raises(ValueError, match="not transposed silently"):
        GaussianProcess(case["x"].T, case["y"], device=CPU)
    with pytest.raises(ValueError, match="method"):
        GaussianProcess(case["x"], case["y"], method="lowrank", device=CPU)
    with pytest.raises(ValueError, match="pipeline"):
        GaussianProcess(case["x"], case["y"], pipeline="nope", device=CPU)
    gp = GaussianProcess(case["x"][:, 0], case["y"], tile_size=M, device=CPU)  # (n,) -> (n, 1)
    assert gp.x_train.shape == (48, 1)
    assert gp.predict(case["xt"][:, 0]).shape == (20,)


def test_default_device_is_cuda_and_never_falls_back(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussianProcess(case["x"], case["y"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pred.predict_fused(case["x"], case["y"], case["xt"], SEKernelParams(), M)


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_from_state_dtype_float64_from_a_float32_state(case, full_cov):
    """``dtype=torch.float64`` on a float32 state pads the test points in float64 and runs the tail there, the state
    cast up; ``dtype=None`` follows the state.  The mean against the reference's ``dtype=jnp.float64`` (x64 on) at
    1e-6: the reference rounds inside its tail to ~1e-7 (8e-8 off a numpy float64 sum).  The reference's full
    covariance at float64 from a float32 state raises in its triangular solve (float32 factor, float64 right-hand
    sides), so both results are also held to numpy float64 on the state's own factor, at 1e-10."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg

    from repro.core import SEKernelParams as JaxParams
    from repro.core import predict as jpred
    from repro_torch.core import tiling

    s = case["state"]
    state = convert.posterior_state_from_numpy(
        s["lpacked"], s["alpha"], s["x_chunks"], s["n"], s["m"], convert.params_from_numpy(*s["params"]),
        s["beta"], s["y_chunks"], device=CPU,
    )
    xt = case["xt"].astype(np.float64) * 1.000001  # test points that float32 cannot hold
    assert pred.predict_from_state(state, xt, full_cov=full_cov, dtype=None)[0].dtype == torch.float32
    got = pred.predict_from_state(state, xt, full_cov=full_cov, dtype=torch.float64)
    got = got if full_cov else (got,)
    assert all(g.dtype == torch.float64 for g in got)
    jax.config.update("jax_enable_x64", True)
    try:
        jst = jpred.PosteriorState(
            lpacked=jnp.asarray(s["lpacked"]), alpha=jnp.asarray(s["alpha"]), x_chunks=jnp.asarray(s["x_chunks"]),
            n=s["n"], m=s["m"], params=JaxParams(*(float(v) for v in s["params"])),
        )
        if full_cov:
            with pytest.raises(TypeError, match="same dtypes"):
                jpred.predict_from_state(jst, jnp.asarray(xt), full_cov=True, dtype=jnp.float64)
        want = np.asarray(jpred.predict_from_state(jst, jnp.asarray(xt), dtype=jnp.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)
    lengthscale, vertical = (float(v) for v in s["params"][:2])

    def se(a, b):
        return vertical * np.exp(-0.5 / lengthscale * ((a[:, None, :] - b[None]) ** 2).sum(-1))

    xc = s["x_chunks"].reshape(-1, s["x_chunks"].shape[-1]).astype(np.float64)
    np.testing.assert_allclose(got[0].numpy(), se(xt, xc) @ s["alpha"].reshape(-1).astype(np.float64),
                               rtol=0, atol=1e-10)
    if full_cov:
        lower = np.tril(tiling.unpack_lower(torch.from_numpy(s["lpacked"])).double().numpy())
        v = scipy.linalg.solve_triangular(lower, se(xc, xt), lower=True)
        np.testing.assert_allclose(got[1].numpy(), se(xt, xt) - v.T @ v, rtol=0, atol=1e-10)
