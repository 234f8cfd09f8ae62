"""Meshes of the port: ``DeviceMesh`` objects over the ranks of an initialized world.

The port runs one process a rank (SPMD): the caller initializes the default
process group (``torch.distributed.init_process_group`` with its backend,
address, world size and rank), and these functions name the ranks' layout.
Every rank makes the same calls in the same order, since a mesh makes
process groups.  A mesh's device type is the one the ranks run on: ``"cuda"``
where the rank has a card (rank r on ``cuda:(r % device_count)``), else
``"cpu"``; ``device_type`` overrides it.

The production mesh and the hardware model of the JAX package's
``launch/mesh.py`` are ROADMAP.md queue 1 step 12.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized default process group (torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_test_mesh(shape: Sequence[int] = (4, 2), axes: Sequence[str] = ("data", "model"), *,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) ranks, row-major, with dims named ``axes``."""
    size = math.prod(shape)
    if len(shape) != len(axes) or not 1 <= size <= _world():
        raise ValueError(f"mesh shape {tuple(shape)} with axes {tuple(axes)} needs 1 ... {_world()} ranks")
    return DeviceMesh(_device_type(device_type), torch.arange(size).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_fleet_mesh(n_devices: Optional[int] = None, *, device_type: Optional[str] = None) -> DeviceMesh:
    """1-D ``("data",)`` mesh for sharding a fleet's problem axis, over the first ``n_devices`` ranks.

    Fleet problems are independent, so ``data`` is the only useful axis
    (:func:`repro_torch.dist.sharding.fleet_spec` splits B over it).
    ``n_devices=None`` takes every rank of the world.
    """
    avail = _world()
    if n_devices is None:
        n_devices = avail
    if not 1 <= n_devices <= avail:
        raise ValueError(f"n_devices must be in [1, {avail}] (ranks of the world); got {n_devices}")
    return make_test_mesh((n_devices,), ("data",), device_type=device_type)
