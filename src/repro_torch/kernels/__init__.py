"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

One module per kernel (``cov_assembly``, ``potrf_tile``, ``trsm_tile``,
``trailing_update``, ``carry_update``, ``lrgemm_tile``, ``flash_attention``), each with a
``*_plain`` function (the same arithmetic in PyTorch ops: the CPU path and
the on-card reference) and a ``*_cuda`` launcher;
:mod:`repro_torch.kernels.ops` dispatches between them by device and counts
launches.  Sources live in ``csrc/`` and are built on first use by
:mod:`repro_torch.kernels._build`.
"""
