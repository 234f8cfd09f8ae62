"""Forward flash attention: the CUDA kernel and its plain version.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (through
``flash_attention_single`` and the batched GQA wrapper ``flash_attention``).
Both functions here take the JAX layout, q (B, S, H, hd) and k, v
(B, T, KV, hd), and return (B, S, H, hd) in q's type; query head h reads KV
head ``h // (H // KV)``.  Scores are float32, scaled by ``1/sqrt(hd)``, then
capped (``softcap * tanh(s / softcap)``), then masked: ``col <= row``
(top-left aligned, as the Pallas kernel) and, with a ``window``, also
``col > row - window`` (the model's local layers).  The softmax's
denominator is floored at 1e-30.  Masked entries weigh exactly 0, so a row
with no unmasked key gives 0.

The plain version materialises the float32 scores (B, KV, H/KV, S, T); the
kernel never holds more than a 64 x 64 block of them.  For bfloat16 inputs
the kernel runs both products on the tensor cores (wgmma, fed by TMA) and
rounds the softmax weights P to bfloat16 for P V (2^-9 of each weight);
float32 inputs stay float32 throughout.  The source, with what bounds it on the H100 and what
the design does about it, is ``csrc/flash_attention.cu``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -(2.0**30)
HEAD_DIMS = (16, 32, 64, 128, 256)  # head sizes the kernel is built for


def _check_args(q, k, v, causal, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes q (B, S, H, hd) and k, v (B, T, KV, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2] != 0:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or "
            f"head size, or H is not a multiple of KV"
        )
    if window is not None and (not causal or window < 1):
        raise ValueError(f"a window ({window}) needs causal=True and window >= 1")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in PyTorch ops, with the float32 scores materialised."""
    _check_args(q, k, v, causal, window)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * (1.0 / math.sqrt(hd))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True)) * mask
    denom = p.sum(-1).clamp_min(1e-30)  # (B, KV, G, S)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float()) / denom.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel: contiguous float32 or bfloat16 operands of one type on one card."""
    _check_args(q, k, v, causal, window)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 operands of one type, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_cuda needs every operand on one CUDA device: {q.device}, "
            f"{k.device}, {v.device}"
        )
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise ValueError("flash_attention takes contiguous operands on 16-byte boundaries")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention is built for head sizes {HEAD_DIMS}, got {hd}")
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, h, kvh, hd, 1.0 / math.sqrt(hd),
        0.0 if softcap is None else float(softcap), int(causal), 0 if window is None else int(window),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "flash_attention")
    return out
