"""Adafactor (factored second moments), the counterpart of ``repro/optim/adafactor.py``.

For a parameter of two or more dims whose two largest dims are both at
least ``min_dim_size_to_factor``, the second moment is stored as row and
column means (``vr``, ``vc``): O(r + c) instead of O(r c); otherwise in
full (``v``).  No momentum.  The arithmetic follows the reference term for
term: ``beta2 = 1 - t^-decay``, ``g^2 + eps``, the factored estimate
``vr / mean(vr) x vc``, and the update's RMS clipped to ``clip_threshold``.
States are float32; :meth:`Adafactor.update` writes the new parameters and
moments into the given tensors under ``torch.no_grad()`` and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adam import learning_rate, step_count
from repro_torch.tree import named_tensors

f32 = np.float32


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    if len(shape) < 2:
        return None
    dims = sorted(range(len(shape)), key=lambda i: shape[i])[-2:]
    return min(dims), max(dims)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    learning_rate: Callable[[int], float] | float = 1e-2
    decay: float = 0.8            # t^-decay running-average schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0   # RMS update clipping
    min_dim_size_to_factor: int = 32

    def _factored(self, shape) -> Optional[Tuple[int, int]]:
        fd = _factored_dims(shape)
        if fd is not None and min(shape[fd[0]], shape[fd[1]]) >= self.min_dim_size_to_factor:
            return fd
        return None

    def init(self, params) -> dict:
        """{"v": name -> {"vr", "vc"} or {"v"} float32 zeros, "step": int32 0}."""
        def leaf(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32, device=p.device)

            fd = self._factored(p.shape)
            if fd is not None:
                return {"vr": zeros(tuple(s for i, s in enumerate(p.shape) if i != fd[1])),
                        "vc": zeros(tuple(s for i, s in enumerate(p.shape) if i != fd[0]))}
            return {"v": zeros(tuple(p.shape))}

        return {"v": {n: leaf(p) for n, p in named_tensors(params).items()},
                "step": torch.zeros((), dtype=torch.int32)}

    def update(self, grads, state, params) -> Tuple[dict, dict]:
        """One step: (params, state), both updated in place."""
        params = named_tensors(params)
        step = step_count(state) + 1
        beta2 = f32(1) - f32(step) ** f32(-self.decay)
        b2, ob2 = float(beta2), float(f32(1) - beta2)
        lr = learning_rate(self.learning_rate, step)
        with torch.no_grad():
            for n, p in params.items():
                g32 = grads[n].float()
                g2 = torch.square(g32) + self.eps
                v = state["v"][n]
                if "vr" in v:
                    r, c = self._factored(p.shape)
                    vr = b2 * v["vr"] + ob2 * torch.mean(g2, dim=c)
                    vc = b2 * v["vc"] + ob2 * torch.mean(g2, dim=r)
                    denom_r = (vr / torch.mean(vr, dim=r, keepdim=True)).unsqueeze(c)
                    u = g32 * torch.rsqrt(denom_r * vc.unsqueeze(r) + self.eps)
                    v["vr"].copy_(vr)
                    v["vc"].copy_(vc)
                else:
                    vv = b2 * v["v"] + ob2 * g2
                    u = g32 * torch.rsqrt(vv + self.eps)
                    v["v"].copy_(vv)
                rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
                p.copy_((p.float() - lr * u).to(p.dtype))
        state["step"] = torch.tensor(step, dtype=torch.int32)
        return params, state

