"""Learning-rate schedules: ``step -> lr`` (a Python float), in the reference's float32 arithmetic."""

from __future__ import annotations

import math

import numpy as np


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak`` then cosine decay to ``floor * peak``."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(int(step))
        warm = f32(peak) * step / f32(max(warmup, 1))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)), f32(0.0), f32(1.0))
        cos = f32(floor * peak) + f32((1 - floor) * peak) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * frac))
        return float(warm if step < warmup else cos)

    return schedule
