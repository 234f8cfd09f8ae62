"""PyTorch/CUDA port of the tiled GP regression package ``repro``.

The layout mirrors ``repro/``: ``core/`` holds tiling, the task scheduler,
the level-batched executor and the prediction pipeline; ``kernels/`` holds
the hand-written Hopper kernels with their plain PyTorch versions.  Entry
points take ``device=`` (default ``"cuda"``) and never fall back to the CPU
on their own.
"""
