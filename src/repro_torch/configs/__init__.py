"""Architecture registry of the port: the configurations its blocks run.

``get_config(arch)`` and ``get_smoke_config(arch)`` return the full and the
reduced configuration, copies of the JAX package's ``CONFIG`` and ``SMOKE``.
The architectures whose layer kinds or inputs the port does not run yet
raise ``NotImplementedError`` naming the ROADMAP.md step that ports them.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_0_5b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
}

# the JAX package's other architectures, with what they wait for
NOT_PORTED: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "the MoE feed-forward (ROADMAP.md queue 1, step 11e)",
    "arctic-480b": "the MoE feed-forward (ROADMAP.md queue 1, step 11e)",
    "llava-next-34b": "the embeddings input (ROADMAP.md queue 1, step 11f)",
    "musicgen-large": "the embeddings input (ROADMAP.md queue 1, step 11f)",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(f"{arch} is not ported yet: it needs {NOT_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown architecture {arch!r}; the port runs {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
