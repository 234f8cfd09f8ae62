"""The two collectives of the port's multi-device paths, over a DeviceMesh's named dims.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``"data"``, ``"model"``, optionally ``"pod"``) over an initialized default
process group, one process a rank.  The paths use two collectives and no
other: :func:`psum`, a sum over the ranks of some mesh axes, and
:func:`gather_axes`, which stacks one tensor of each rank along a new
leading axis.  Several axis names, as ``("pod", "data")``, mean one group
over the flattened axes, and a rank's place along them is its linear index
in the order given (the first axis outermost), the JAX package's
``lax.axis_index`` order.  The library never picks a backend: a group is
the mesh's own for one axis, and for several it is made (``new_group``, a
call every rank makes) over the mesh's ranks.  Gloo and NCCL both take
the list form of ``all_gather``.

:data:`STATS` counts the calls, the bytes each rank sends and the host
seconds spent inside the calls (a call waits for the device work queued
before it, so on the card this includes that wait).  Inside
:func:`recording` each call also appends ``(op, group size, result
bytes)`` to the list it yields, ``op`` ``"all-reduce"`` or
``"all-gather"`` (the launch tools' wire model reads them,
``launch/analysis.py``).  A group of one rank makes no call.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], tuple] = {}
_RECORD: Optional[List[Tuple[str, int, int]]] = None


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)


@contextlib.contextmanager
def recording():
    """A list that gets ``(op, group size, result bytes)`` for each collective call inside the block, in order."""
    global _RECORD
    before, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = before


def _count(t0: float, op: str, group: int, sent: int, result: int) -> None:
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += sent
    if _RECORD is not None:
        _RECORD.append((op, group, result))


def check_mesh(mesh, where: str) -> None:
    """``mesh`` is None or a DeviceMesh with named dims, else TypeError."""
    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{where}: mesh must be a torch.distributed.device_mesh.DeviceMesh or None; "
                        f"got {type(mesh).__name__}")
    if not mesh.mesh_dim_names:
        raise TypeError(f"{where}: the mesh needs named dims (mesh_dim_names), as ('data', 'model')")


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axes_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def coordinates(mesh: DeviceMesh, rank: int = None) -> Dict[str, int]:
    """``{axis: position}`` of ``rank`` (default this process) on the mesh; ValueError off the mesh."""
    rank = dist.get_rank() if rank is None else rank
    hit = (mesh.mesh == rank).nonzero()
    if not len(hit):
        raise ValueError(f"rank {rank} is not on the mesh {mesh.mesh.tolist()}")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in hit[0])))


def linear_index(mesh: DeviceMesh, axes: Sequence[str], coord: Dict[str, int] = None) -> int:
    """The rank's place over ``axes`` (first axis outermost); ``coord`` defaults to this rank's."""
    coord = coordinates(mesh) if coord is None else coord
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def _group(mesh: DeviceMesh, axes: Tuple[str, ...]):
    """(process group over ``axes`` holding this rank, each member's linear index in group-rank order)."""
    key = (id(mesh), axes)
    if key not in _GROUPS:
        if len(axes) == 1:
            group = mesh.get_group(axes[0])
        else:
            names = list(mesh.mesh_dim_names)
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            lines = mesh.mesh.permute(rest + dims).reshape(-1, axes_size(mesh, axes))
            me, group = dist.get_rank(), None
            for line in lines.tolist():  # every rank makes every group, in the same order
                g = dist.new_group(line)
                if me in line:
                    group = g
        ranks = dist.get_process_group_ranks(group)
        order = [linear_index(mesh, axes, coordinates(mesh, r)) for r in ranks]
        _GROUPS[key] = (group, order, mesh)  # the mesh is kept so that its id is not reused
    return _GROUPS[key][:2]


def psum(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a new tensor; ``x`` is left as it was)."""
    axes = tuple(axes)
    out = x.contiguous().clone()
    if axes_size(mesh, axes) == 1:
        return out
    group, order = _group(mesh, axes)
    t0 = time.perf_counter()
    dist.all_reduce(out, group=group)
    size = out.numel() * out.element_size()
    _count(t0, "all-reduce", len(order), size, size)
    return out


def gather_axes(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """(S,) + x.shape: every rank's ``x`` over ``axes``, stacked in linear-index order."""
    axes = tuple(axes)
    x = x.contiguous()
    if axes_size(mesh, axes) == 1:
        return x[None].clone()
    group, order = _group(mesh, axes)
    parts = [torch.empty_like(x) for _ in order]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=group)
    size = x.numel() * x.element_size()
    _count(t0, "all-gather", len(order), size, size * len(order))
    out = [None] * len(order)
    for part, k in zip(parts, order):
        out[k] = part
    return torch.stack(out)
