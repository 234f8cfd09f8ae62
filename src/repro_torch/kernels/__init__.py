"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

One module per kernel (``cov_assembly``, ``potrf_tile``, ``trsm_tile``,
``trailing_update``, ``carry_update``, ``lrgemm_tile``, ``flash_attention``), each with a
``*_plain`` function (the same arithmetic in PyTorch ops: the CPU path and
the on-card reference) and a ``*_cuda`` launcher;
:mod:`repro_torch.kernels.ops` dispatches between them by device and counts
launches.  Sources live in ``csrc/`` and are built on first use by
:mod:`repro_torch.kernels._build`.
"""


def build_kernels(device) -> float:
    """Build and load every kernel for a run on ``device``; returns the seconds it took.

    On the card the libraries are compiled (those not yet built) and loaded,
    so that the first call of an entry point times its own work and not
    ``nvcc``; on the CPU the plain versions need nothing and this returns 0.
    """
    import time

    import torch

    if torch.device(device).type != "cuda":
        return 0.0
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.load(name)
    return time.perf_counter() - t0
