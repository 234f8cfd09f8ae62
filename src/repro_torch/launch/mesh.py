"""Meshes of the port: ``DeviceMesh`` objects over the ranks of an initialized world.

The port runs one process a rank (SPMD): the caller initializes the default
process group (``torch.distributed.init_process_group`` with its backend,
address, world size and rank), and these functions name the ranks' layout.
Every rank makes the same calls in the same order, since a mesh makes
process groups.  A mesh's device type is the one the ranks run on: ``"cuda"``
where the rank has a card (rank r on ``cuda:(r % device_count)``), else
``"cpu"``; ``device_type`` overrides it.

:func:`make_production_mesh` names the JAX package's production meshes,
(16, 16) ``("data", "model")`` and (2, 16, 16) with a ``pod`` axis, over a
world of 256 or 512 ranks (the dry-run builds that world on torch's ``fake``
backend in one process).  :class:`Hardware` is the roofline's device model,
and :data:`H100_SXM` (in place of the JAX package's TPU v5e) holds the
published peaks of one NVIDIA H100 SXM.
"""

from __future__ import annotations

import dataclasses
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


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")``, over the world's first ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, device_type=device_type)


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peaks: the three roofline terms are the work over these rates.

    The compute term takes the peak of the cell's compute type
    (``peak_flops_bf16`` for bf16, ``peak_flops_fp32`` for float32), since
    a float32 cell does not run at the tensor cores' bf16 rate.
    ``link_bandwidth`` is the bytes a second one device puts on the wire of
    a collective.
    """

    peak_flops_bf16: float
    peak_flops_fp32: float
    hbm_bandwidth: float      # B/s per device
    link_bandwidth: float     # B/s per device on the wire
    hbm_bytes: float          # capacity per device

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        return {"bfloat16": self.peak_flops_bf16, "float32": self.peak_flops_fp32}[dtype]

    def compute_seconds(self, flops_per_device: float, dtype: str = "bfloat16") -> float:
        return flops_per_device / self.peak_flops(dtype)

    def memory_seconds(self, bytes_per_device: float) -> float:
        return bytes_per_device / self.hbm_bandwidth

    def collective_seconds(self, wire_bytes_per_device: float) -> float:
        return wire_bytes_per_device / self.link_bandwidth


# One NVIDIA H100 SXM5 80GB at its 700 W limit, published peaks: 989 TFLOP/s bf16 dense on the tensor cores, 67
# TFLOP/s FP32 on the CUDA cores, 3.35 TB/s HBM3, 80 GB.  The wire rate is one 400 Gb/s NDR InfiniBand port a GPU,
# 50 GB/s: every axis of both production meshes (16 or 32 ranks) spans more than one 8-GPU NVLink node, so a
# collective over it crosses the network, not NVLink (450 GB/s a direction).
H100_SXM = Hardware(peak_flops_bf16=989e12, peak_flops_fp32=67e12, hbm_bandwidth=3.35e12, link_bandwidth=50e9,
                    hbm_bytes=80e9)
