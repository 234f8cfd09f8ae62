"""The system under test: the PyTorch/CUDA port's public GP entry points.

The only module of the benchmark that imports the port (``repro_torch``).
It builds a :class:`repro_torch.core.GaussianProcess` from a configuration
file's keys and reads the port's telemetry counters.  The reference
(``bench/reference/``) never imports this module.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_libraries(device) -> None:
    """Build (first run in a checkout) and load the port's CUDA libraries, as a first kernel launch would."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.load(_build.SOURCES[0])


def make_gp(cfg: Dict, x: torch.Tensor, y: torch.Tensor, device):
    """A new GaussianProcess on (x, y) with the configuration's pipeline and hyperparameters."""
    from repro_torch.core import GaussianProcess, SEKernelParams

    p = cfg["params"]
    kw = dict(
        params=SEKernelParams(p["lengthscale"], p["vertical"], p["noise"]),
        tile_size=cfg["tile_size"], dtype=DTYPES[cfg["dtype"]], kernel=cfg["kernel"], device=device,
    )
    if cfg["method"] == "lowrank":
        kw.update(method="lowrank", m_inducing=cfg["m_inducing"], strategy=cfg["strategy"], jitter=cfg["jitter"])
    else:
        kw.update(method="exact", pipeline=cfg["pipeline"], fused=cfg["fused"])
    return GaussianProcess(x, y, **kw)


@contextlib.contextmanager
def loss_curves() -> Iterator[List[torch.Tensor]]:
    """Collect the loss curve of each ``GaussianProcess.optimize`` call in the block.

    ``optimize`` keeps the hyperparameters that
    ``mll.optimize_hyperparameters`` returns and drops the loss curve beside
    them; the curve is part of what the call computed, and ``correct``
    compares it, so the function is wrapped for the block and restored after.
    """
    from repro_torch.core import mll

    inner = mll.optimize_hyperparameters
    curves: List[torch.Tensor] = []

    def recording(*args, **kwargs):
        params, losses = inner(*args, **kwargs)
        curves.append(losses)
        return params, losses

    mll.optimize_hyperparameters = recording
    try:
        yield curves
    finally:
        mll.optimize_hyperparameters = inner


def counters_on() -> None:
    import repro_torch.obs as obs

    obs.reset()
    obs.enable()


def counters() -> Dict[str, float]:
    """The port's telemetry counters since :func:`counters_on`; telemetry is switched off again."""
    import repro_torch.obs as obs

    out = dict(obs.snapshot()["counters"])
    obs.disable()
    obs.reset()
    return out
