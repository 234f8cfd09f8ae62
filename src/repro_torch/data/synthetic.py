"""Synthetic data generators: LM token streams and GP function draws (numpy, the reference's arrays).

The counterpart of ``repro/data/synthetic.py``: the same generator calls in
the same order, so that a seed gives the same arrays as the JAX package's.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def token_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    n_batches: int | None = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic synthetic LM batches: a learnable Markov-ish stream.

    Tokens follow t_{i+1} = (a * t_i + b + noise) mod V with per-sequence
    (a, b), so that a model can reduce the loss below uniform.  Yields
    (tokens, labels) int32 (batch, seq_len), labels the next token.
    """
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches is None or i < n_batches:
        a = rng.integers(1, 8, size=(batch, 1))
        b = rng.integers(0, vocab_size, size=(batch, 1))
        t0 = rng.integers(0, vocab_size, size=(batch, 1))
        seq = np.empty((batch, seq_len + 1), np.int32)
        seq[:, :1] = t0
        for s in range(seq_len):
            noise = rng.integers(0, 2, size=(batch, 1))
            seq[:, s + 1 : s + 2] = (a * seq[:, s : s + 1] + b + noise) % vocab_size
        yield seq[:, :-1], seq[:, 1:]
        i += 1


def gp_function_draw(
    n: int, d: int = 1, *, lengthscale: float = 1.0, noise: float = 0.05, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw (X (n, d), y (n,)) float32 from an SE GP prior plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=(n, d))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = np.exp(-0.5 * d2 / lengthscale) + 1e-8 * np.eye(n)
    y = np.linalg.cholesky(k) @ rng.standard_normal(n)
    return x.astype(np.float32), (y + rng.normal(0, noise, n)).astype(np.float32)
