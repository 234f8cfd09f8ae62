"""Sharding rules: the language model's parameters, states, inputs and caches, and fleets' problem axis.

**Language model** (the counterpart of the reference's greedy FSDP+TP
rule).  :func:`_leaf_spec` gives a leaf of a shape the reference's spec on a
mesh of the same axis sizes: the largest dim that the ``model`` axis
divides is split over ``model``, the largest remaining dim that ``data``
divides over ``data``; dims that do not divide stay whole.
:func:`batch_spec` splits a batch-leading array over the data-parallel axes
``("pod", "data")`` that divide it.  A spec is a tuple with one entry a dim:
None, an axis name, or a tuple of axis names (the reference's
``PartitionSpec`` entries).  A :class:`Sharding` (mesh, spec) is the port's
``NamedSharding``: :meth:`Sharding.block` cuts this rank's block of a full
tensor, :meth:`Sharding.gather` puts the full tensor together from every
rank's block (one ``gather_axes`` over the spec's axes).  The step
factories store each parameter and optimizer moment as the rank's block and
gather a parameter before use (``repro_torch.train``): the reference's
"shardings change layout, never semantics", in SPMD form.

**Fleets** (DESIGN.md §12): data parallelism over a fleet's problem axis B.

Every stacked buffer of a fleet's programs leads with B, and the problems
are independent, so splitting B over the mesh's data-parallel axes needs no
collective inside a program.  In the port's SPMD form every rank calls the
same function with the same (replicated) inputs, runs the programs on its
own contiguous slice of B, keeps the states of its slice, and the results
are gathered once at the output (:func:`gather_fleet`), so a caller gets
the global array on every rank.  When no product of the present DP axes
divides B, every rank runs the whole of B: replication, never an error.
Plans never see the mesh: they depend on tile counts, not on B.

"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist import collectives as coll
from repro_torch.tree import leaves, map_tree

DP_AXES: Tuple[str, ...] = ("pod", "data")  # batch axes, outermost first
FSDP_AXIS = "data"
TP_AXIS = "model"


def _present(mesh: DeviceMesh, axes: Sequence[str]) -> Tuple[str, ...]:
    sizes = coll.axis_sizes(mesh)
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def _dp_axes_for(mesh: DeviceMesh, batch: int) -> Tuple[str, ...]:
    """The largest prefix-product of present DP axes that divides the batch."""
    dp = _present(mesh, DP_AXES)
    while dp and batch % coll.axes_size(mesh, dp):
        dp = dp[1:]  # drop the outermost axis until the product divides
    return dp


# ---------------------------------------------------------------------------
# The language model's rules.
# ---------------------------------------------------------------------------


def batch_spec(mesh: DeviceMesh, batch: int, *rest) -> tuple:
    """The spec of a batch-leading array: its batch over the DP axes that divide it; ``rest`` passes through."""
    dp = _dp_axes_for(mesh, batch)
    return (dp if dp else None, *rest)


def _leaf_spec(shape: Sequence[int], mesh: DeviceMesh) -> tuple:
    """The greedy FSDP+TP spec of one parameter-like leaf (the reference's rule, dim for dim)."""
    sizes = coll.axis_sizes(mesh)
    spec = [None] * len(shape)
    for axis in (TP_AXIS, FSDP_AXIS):
        if sizes.get(axis, 1) <= 1:
            continue
        size = sizes[axis]
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if spec[d] is None and shape[d] % size == 0 and shape[d] >= size:
                spec[d] = axis
                break
    return tuple(spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (None, a name, or a tuple of names), as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout over ``mesh``: ``spec`` names, a dim at a time, the axes that split that dim."""

    mesh: DeviceMesh
    spec: tuple

    def _dims(self):
        return [(d, spec_axes(e)) for d, e in enumerate(self.spec) if spec_axes(e)]

    def block_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for d, axes in self._dims():
            out[d] //= coll.axes_size(self.mesh, axes)
        return tuple(out)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a copy that does not hold ``full``'s storage)."""
        if not self._dims():
            return full
        coord = coll.coordinates(self.mesh)
        index = [slice(None)] * full.ndim
        for d, axes in self._dims():
            share = full.shape[d] // coll.axes_size(self.mesh, axes)
            k = coll.linear_index(self.mesh, axes, coord)
            index[d] = slice(k * share, (k + 1) * share)
        return full[tuple(index)].clone(memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block: one ``gather_axes`` over the spec's axes (every rank calls it)."""
        dims = self._dims()
        if not dims:
            return local
        axes = tuple(a for _, ax in dims for a in ax)
        sizes = [coll.axes_size(self.mesh, ax) for _, ax in dims]
        parts = coll.gather_axes(local, self.mesh, axes).reshape(*sizes, *local.shape)
        group_of = {d: j for j, (d, _) in enumerate(dims)}
        order, shape = [], []
        for i in range(local.ndim):
            if i in group_of:
                order.append(group_of[i])
            order.append(len(dims) + i)
            shape.append(local.shape[i] * (sizes[group_of[i]] if i in group_of else 1))
        return parts.permute(order).reshape(shape)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def param_shardings(params, mesh: DeviceMesh):
    """{name: Sharding} of a model's parameters (a ``Transformer``, on any device, or a name -> tensor mapping)."""
    return map_tree(lambda p: Sharding(mesh, _leaf_spec(_shape(p), mesh)), params)


def opt_state_shardings(opt_state, params, mesh: DeviceMesh):
    """An optimizer state's shardings: each moment by its own shape's rule, a scalar (the step) replicated."""
    del params  # the rule is shape-driven, as the reference's; kept for its signature
    return map_tree(lambda l: Sharding(mesh, _leaf_spec(_shape(l), mesh)), opt_state)


def input_shardings(cfg, shape, mesh: DeviceMesh) -> Tuple[Sharding, Sharding]:
    """(inputs, labels) shardings of one shape cell: the batch over the DP axes; (B, S, d) embeddings inputs for
    ``cfg.input_mode == "embeddings"``, (B, S) ids otherwise."""
    b = shape.global_batch
    rest = (None, None) if cfg.input_mode == "embeddings" else (None,)
    return Sharding(mesh, batch_spec(mesh, b, *rest)), Sharding(mesh, batch_spec(mesh, b, None))


def cache_shardings(cfg, batch: int, mesh: DeviceMesh, caches):
    """Decode-cache shardings: a leaf's batch dim over the DP axes, the rest whole."""
    del cfg
    dp = _dp_axes_for(mesh, batch)

    def leaf(l):
        spec = [None] * len(_shape(l))
        if dp and spec and l.shape[0] == batch:
            spec[0] = dp
        return Sharding(mesh, tuple(spec))

    return map_tree(leaf, caches)


def distribute(tree, shardings):
    """Each tensor leaf's block for this rank (the port's ``device_put`` of a sharded tree)."""
    return map_tree(lambda t, s: s.block(t) if isinstance(t, torch.Tensor) else t, tree, shardings)


def collect(tree, shardings):
    """Each leaf's full tensor from every rank's block (every rank calls it)."""
    return map_tree(lambda t, s: s.gather(t) if isinstance(t, torch.Tensor) else t, tree, shardings)


def local_bytes(tree) -> int:
    """The bytes of a tree's tensor leaves on this rank."""
    return sum(t.numel() * t.element_size() for t in leaves(tree) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Fleets.
# ---------------------------------------------------------------------------


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

