"""The port's flash attention (``ops.flash_attention``) against the JAX package's.

On CPU tensors the op runs the kernel's plain version; the JAX side runs the
Pallas kernel in interpret mode, as ``tests/test_flash_attention.py`` does.
Inputs come from numpy with a seed and go to both.  Tolerances are the
reference test's own: atol 5e-5 in float32, 2e-2 in bfloat16.  The window
and a ragged S (which the Pallas wrapper refuses) are held against the JAX
model's masked-softmax attention with ``_causal_mask(pos, pos, window)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.kernels.flash_attention import flash_attention, flash_attention_single
from repro.models.attention import _causal_mask, _scores_softmax_out
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops


def _single(q, k, v, **kw):
    """One head through the port: (S, hd) -> (1, S, 1, hd) and back."""
    t = [torch.from_numpy(a)[None, :, None, :] for a in (q, k, v)]
    return ops.flash_attention(*t, **kw)[0, :, 0].numpy()


@pytest.mark.parametrize("shape", [(64, 64, 16), (128, 128, 32), (96, 192, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_single_head_matches_pallas(rng, shape, causal):
    s, t, hd = shape
    q, k, v = (rng.standard_normal((n, hd)).astype(np.float32) for n in (s, t, t))
    want = flash_attention_single(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=32, block_k=32
    )
    np.testing.assert_allclose(_single(q, k, v, causal=causal), np.asarray(want), atol=5e-5)


def test_softcap_matches_pallas(rng):
    s, hd = 64, 32
    q, k, v = (rng.standard_normal((s, hd)).astype(np.float32) * 3 for _ in range(3))
    want = flash_attention_single(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, softcap=10.0, block_q=32, block_k=32
    )
    np.testing.assert_allclose(_single(q, k, v, softcap=10.0), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("softcap", [None, 10.0])
def test_gqa_matches_pallas(rng, dtype, tol, softcap):
    b, s, h, kv, hd = 2, 64, 8, 4, 16
    arrs = [rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (h, kv, kv)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = flash_attention(*(jnp.asarray(a, jdt) for a in arrs), causal=True, softcap=softcap,
                           block_q=32, block_k=32)
    # the same bf16-rounded inputs on both sides
    got = ops.flash_attention(
        *(torch.from_numpy(np.array(jnp.asarray(a, jdt), np.float32)).to(getattr(torch, dtype)) for a in arrs),
        causal=True, softcap=softcap,
    )
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, hd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize(
    "s,window,softcap",
    [(64, 16, None), (100, 7, 50.0), (77, None, 50.0), (33, 1, None), (130, 64, 10.0)],
)
def test_window_and_ragged_match_masked_softmax(rng, s, window, softcap):
    """Any S (no block multiple) and a sliding window, against the model's einsum attention."""
    b, h, kv, hd = 2, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32) * 2 for n in (h, kv, kv))
    cfg = configs.get_smoke_config("gemma2-2b")
    cfg = type(cfg)(**{**cfg.__dict__, "attn_softcap": softcap})
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want = _scores_softmax_out(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               _causal_mask(pos, pos, window), cfg)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_masked_rows_and_arguments(rng):
    """A row with no unmasked key gives 0; a window needs causal; bad shapes raise."""
    q = torch.from_numpy(rng.standard_normal((1, 6, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 3, 1, 16)).astype(np.float32))
    # rows 5 (cols 0..2 all <= 5 - 2) has no key inside a window of 2
    out = tfa.flash_attention_plain(q, k, k, window=2)
    assert torch.all(out[0, 5] == 0) and torch.all(torch.isfinite(out))
    assert not torch.all(out[0, 2] == 0)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, causal=False, window=2)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[..., :8], k[..., :8])
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, k, k)  # CPU tensors: the launcher refuses them
