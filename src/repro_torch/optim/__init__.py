"""Optimizers and distributed-optimization utilities (the counterpart of ``repro/optim``)."""

from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adam import Adam, global_norm
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["Adam", "Adafactor", "cosine_warmup", "global_norm"]
