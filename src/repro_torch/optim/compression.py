"""Gradient compression with error feedback, the counterpart of ``repro/optim/compression.py``.

Int8 uniform quantization with a per-chunk max-abs scale; the quantization
residual is carried in a local error-feedback buffer and added to the next
step's gradient (Seide et al. 2014; Karimireddy et al. 2019).

* :func:`compress` / :func:`decompress`: the quantizer; its int8 payload
  equals the reference's (``torch.round`` rounds half to even, as
  ``jnp.round``), and |g - deq(q(g))| <= scale / 2 elementwise.
* :func:`compressed_psum`: the mean of a gradient over one mesh axis, by an
  all-gather of every rank's int8 payload and scales over that axis
  (``dist.collectives.gather_axes``) and a local dequantized average.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll


def compress(g: torch.Tensor, chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (any shape) -> (int8 payload (n_chunks, chunk), float32 scales (n_chunks,))."""
    flat = g.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % chunk))
    chunks = flat.reshape(-1, chunk)
    scale = torch.amax(torch.abs(chunks), dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(chunks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)[:size]
    return flat.reshape(shape)


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor, chunk: int = 4096):
    """Error-feedback wrapper: (q, scale, new_err)."""
    g_corr = g.float() + err
    q, scale = compress(g_corr, chunk)
    deq = decompress(q, scale, g.shape, g.numel())
    return q, scale, g_corr - deq


def compressed_psum(g: torch.Tensor, err: torch.Tensor, mesh, axis: str, chunk: int = 4096):
    """Mean of ``g`` over mesh axis ``axis`` through the int8 payload, with error feedback: (g_mean, new_err).

    Every rank on the axis calls it (SPMD); the payload and the scales of
    every rank along ``axis`` are gathered, dequantized and averaged here.
    """
    q, scale, new_err = compress_with_feedback(g, err, chunk)
    qs = coll.gather_axes(q, mesh, (axis,))              # (P, n_chunks, chunk)
    ss = coll.gather_axes(scale, mesh, (axis,))          # (P, n_chunks)
    total = torch.einsum("pnc,pn->nc", qs.float(), ss)
    n = coll.axes_size(mesh, (axis,))
    mean = (total / n).reshape(-1)[: g.numel()].reshape(g.shape)
    return mean.to(g.dtype), new_err
