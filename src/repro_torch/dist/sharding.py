"""Fleet sharding: data parallelism over a fleet's problem axis B (DESIGN.md §12).

Every stacked buffer of a fleet's programs leads with B, and the problems
are independent, so splitting B over the mesh's data-parallel axes needs no
collective inside a program.  In the port's SPMD form every rank calls the
same function with the same (replicated) inputs, runs the programs on its
own contiguous slice of B, keeps the states of its slice, and the results
are gathered once at the output (:func:`gather_fleet`), so a caller gets
the global array on every rank.  When no product of the present DP axes
divides B, every rank runs the whole of B: replication, never an error.
Plans never see the mesh: they depend on tile counts, not on B.

The rules for parameters, optimizer states, inputs and caches of the
language-model steps are ROADMAP.md queue 1 step 10b.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist import collectives as coll

DP_AXES: Tuple[str, ...] = ("pod", "data")  # batch axes, outermost first


def _present(mesh: DeviceMesh, axes: Sequence[str]) -> Tuple[str, ...]:
    sizes = coll.axis_sizes(mesh)
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def _dp_axes_for(mesh: DeviceMesh, batch: int) -> Tuple[str, ...]:
    """The largest prefix-product of present DP axes that divides the batch."""
    dp = _present(mesh, DP_AXES)
    while dp and batch % coll.axes_size(mesh, dp):
        dp = dp[1:]  # drop the outermost axis until the product divides
    return dp


def fleet_axes(mesh: DeviceMesh, batch: int) -> Tuple[str, ...]:
    """DP axes the problem axis shards over (() replicates: no DP axis divides B)."""
    return _dp_axes_for(mesh, batch)


def slice_of(mesh: DeviceMesh, batch: int, coord: Dict[str, int]) -> slice:
    """The rows of B that the rank at ``coord`` runs: its contiguous share, or all of B."""
    dp = _dp_axes_for(mesh, batch)
    if not dp:
        return slice(0, batch)
    share = batch // coll.axes_size(mesh, dp)
    k = coll.linear_index(mesh, dp, coord)
    return slice(k * share, (k + 1) * share)


def fleet_spec(mesh: DeviceMesh, batch: int, ndim: int = 1) -> slice:
    """This rank's rows of a B-leading buffer (every trailing dim is whole, whatever ``ndim``)."""
    del ndim  # the rows are the spec; kept for the reference's signature
    return slice_of(mesh, batch, coll.coordinates(mesh))


def fleet_hint(x, mesh: Optional[DeviceMesh]):
    """The identity: a rank-local tensor is already laid out (the reference pins a layout here)."""
    del mesh
    return x


def device_put_fleet(x, mesh: Optional[DeviceMesh]):
    """This rank's slice of a B-leading tensor (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    return x[fleet_spec(mesh, x.shape[0])]


def gather_fleet(x: torch.Tensor, mesh: Optional[DeviceMesh], batch: int) -> torch.Tensor:
    """The global (B, ...) result from every rank's slice ``x``; a replicated B is returned as it is."""
    if mesh is None:
        return x
    dp = _dp_axes_for(mesh, batch)
    if not dp:
        return x
    return coll.gather_axes(x, mesh, dp).reshape((batch,) + tuple(x.shape[1:]))


def dp_peers(mesh: DeviceMesh) -> List[Dict[str, int]]:
    """The coordinates of the ranks that share this rank's non-DP coordinates, in linear order over the
    present DP axes: the group among which a fleet's problems are split."""
    me = coll.coordinates(mesh)
    dp = _present(mesh, DP_AXES)
    sizes = coll.axis_sizes(mesh)
    peers = []
    for k in range(coll.axes_size(mesh, dp)):
        coord, rest = dict(me), k
        for a in reversed(dp):
            coord[a], rest = rest % sizes[a], rest // sizes[a]
        peers.append(coord)
    return peers


def psum_dp(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of ``x`` over :func:`dp_peers` (the psum-mask exchange of rows between them)."""
    return coll.psum(x, mesh, _present(mesh, DP_AXES))


def local_params(params, mesh: Optional[DeviceMesh], batch: int, kernel):
    """The params tree with its per-problem ((B,) + base) leaves cut to this rank's rows."""
    if mesh is None:
        return params
    from repro_torch.core import kernels_math as km

    return km.gather_params(params, fleet_spec(mesh, batch), kernel)


def local_rows(v, mesh: Optional[DeviceMesh], batch: int):
    """This rank's rows of a per-problem (B,) argument (a tensor, array or list); others pass through."""
    if mesh is None or v is None or isinstance(v, (int, float)):
        return v
    if isinstance(v, torch.Tensor) and v.ndim == 0:
        return v
    rows = fleet_spec(mesh, batch)
    return v[rows] if not isinstance(v, tuple) else tuple(v[rows])


def gather_tree(out, mesh: Optional[DeviceMesh], batch: int):
    """:func:`gather_fleet` over a tensor or a tuple of them."""
    if isinstance(out, tuple):
        return tuple(gather_fleet(t, mesh, batch) for t in out)
    return gather_fleet(out, mesh, batch)

