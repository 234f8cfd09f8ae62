"""Architecture registry of the port: the configurations its blocks run.

``get_config(arch)`` and ``get_smoke_config(arch)`` return the full and the
reduced configuration, copies of the JAX package's ``CONFIG`` and ``SMOKE``;
``ARCH_IDS`` lists the same ten architectures in the same order.
``shapes_for(arch)`` and ``all_cells()`` give the launch tools' (arch ×
shape) cells, as the JAX package's do.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    GPShapeConfig,
    ModelConfig,
    ShapeConfig,
)

_MODULES: Dict[str, str] = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_0_5b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)

# the sub-quadratic architectures, which also run the long_500k decode cell
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown architecture {arch!r}; the port runs {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shapes_for(arch: str) -> Tuple[ShapeConfig, ...]:
    """The shape cells of one architecture: train, prefill and decode, and long_500k where it is sub-quadratic."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch in LONG_CONTEXT_ARCHS:
        out.append(LONG_500K)
    return tuple(out)


def all_cells():
    """Every (arch, shape) cell of the launch tools, long_500k included where it applies."""
    for arch in ARCH_IDS:
        for shape in shapes_for(arch):
            yield arch, shape
