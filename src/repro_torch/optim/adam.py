"""AdamW with float32 state, global-norm clipping, and decoupled weight decay.

The counterpart of ``repro/optim/adam.py``, term for term: the clip
``min(1, clip_norm / (|g| + 1e-9))`` in the gradients' type, float32
moments whatever the parameters' type, the bias corrections in float32, and
the decay added to the update as ``u + wd * p`` (``torch.optim.AdamW``
decays the parameters instead, which differs).  ``params`` and ``grads``
are name -> tensor mappings (a ``Transformer`` stands for its
``named_parameters()``); :meth:`Adam.update` writes the new parameters and
moments into the given tensors under ``torch.no_grad()`` (the port's
counterpart of the reference's donated buffers) and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, named_tensors

f32 = np.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def learning_rate(schedule, step: int) -> float:
    return float(schedule(step)) if callable(schedule) else schedule


def step_count(state) -> int:
    return int(state["step"])


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: Callable[[int], float] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> dict:
        """{"m", "v": name -> float32 zeros on each parameter's device, "step": int32 0}."""
        params = named_tensors(params)

        def zeros():
            return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}

        return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32)}

    def update(self, grads, state, params, *, grad_norm=None) -> Tuple[dict, dict]:
        """One step: (params, state), both updated in place.

        ``grad_norm`` is the global norm to clip by when ``grads`` hold only
        some of the gradients (a sharded step's blocks); default their own.
        """
        params = named_tensors(params)
        step = step_count(state) + 1
        g = {n: grads[n] for n in params}
        if self.clip_norm is not None:
            gn = global_norm(g) if grad_norm is None else grad_norm
            scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
            g = {n: x * scale.to(x.dtype) for n, x in g.items()}
        t = f32(step)
        bc1, bc2 = float(f32(1) - f32(self.b1) ** t), float(f32(1) - f32(self.b2) ** t)
        lr = learning_rate(self.learning_rate, step)
        with torch.no_grad():
            for n, p in params.items():
                g32 = g[n].float()
                m, v = state["m"][n], state["v"][n]
                m.copy_(self.b1 * m + (1 - self.b1) * g32)
                v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g32))
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
        state["step"] = torch.tensor(step, dtype=torch.int32)
        return params, state
