"""The process environment of a run: its caches inside the checkout, and the port on the import path."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHES = (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "cuda_cache"))


def prepare() -> None:
    """Point every kernel cache at a fixed directory under ``build/bench/`` of the checkout and put
    ``src/`` on the import path; call before torch is imported."""
    for var, sub in CACHES:
        os.environ[var] = str(ROOT / "build" / "bench" / sub)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
