"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port is
written for the card, and a caller who wants the plain CPU versions (the
tests) asks for them with ``device="cpu"``.  Nothing falls back to the CPU
on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev



def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU).

    A host clock read after it times the card's work, not the launches.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
