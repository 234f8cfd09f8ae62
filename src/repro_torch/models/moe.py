"""Mixture-of-experts feed-forward: token-choice top-k routing with capacity.

The counterpart of ``repro/models/moe.py``.  Tokens are routed in groups of
``router_group_size`` (one group of all b·s tokens when the group size does
not divide them, the reference's fallback).  Within a group each token picks
its k experts by a float32 router (softmax, top-k in descending order, the
gates renormalised with ``+ 1e-9``), and each (token, choice) takes a
position in its expert's buffer of :func:`capacity` rows: choice 0 of every
token before choice 1, tokens in order within a choice (the reference's k
one-hot cumsum passes).  A choice past the capacity is dropped: its gate
counts as 0.  Dispatch is an index table: a gather of the tokens into
(E, capacity, d) buffers (a zero row stands for an empty slot), batched
expert GEMMs (SwiGLU, or GELU when ``cfg.mlp`` is not swiglu), and a combine
that gathers each kept choice's row and sums them weighted by ``gate · keep``
in x's type.  The reference computes the expert products with XLA einsums
outside any Pallas kernel, and the port with ``torch.bmm``.  arctic's dense
residual (``cfg.dense_residual``) adds a dense MLP of the same input.

**Routing under a data mesh.**  The reference is one program over the
global batch, so its groups are groups of the global b·s tokens; the port
runs one process a rank on the rank's rows.  Inside :func:`routing_over`
(which the sharded serve and train steps enter) a rank routes its tokens as
parts of the global groups.  When its tokens are whole groups it routes
them alone.  When a group straddles ranks, every rank all-gathers a
(groups, k, E) int32 table of the choices its tokens make in each pass (one
``gather_axes`` a layer), and each expert's positions on a rank start after
those of the passes before and of the ranks before it.  Positions, drops
and outputs are then the reference's: an expert's output for a token
depends on that token alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gp import ieee_float32_matmul
from repro_torch.dist import collectives as coll
from repro_torch.models.layers import MLP, _gelu_tanh, _param, apply_mlp, init_mlp_, init_param_


class MoE(nn.Module):
    """``router`` (d, E), float32 whatever the parameter type; ``w_gate``, ``w_up`` (E, d, ff) and ``w_down``
    (E, ff, d); ``dense``, an :class:`MLP`, with ``cfg.dense_residual``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, ff), dtype, device)
        self.w_up = _param((e, d, ff), dtype, device)
        self.w_down = _param((e, ff, d), dtype, device)
        if cfg.dense_residual:
            self.dense = MLP(cfg.mlp, d, cfg.d_ff, dtype, device)


def init_moe_(moe: MoE, generator: torch.Generator) -> MoE:
    """Draw in place at the reference's scales: 1/sqrt(d) into the router and the up projections, 1/sqrt(ff) out.

    An expert leaf is drawn one expert at a time: arctic's (128, 7168, 4864)
    leaf drawn whole would take 17.9 GB of float32 beside its 8.9 GB.
    """
    e, d, ff = moe.w_gate.shape
    init_param_(moe.router, generator, 1.0 / math.sqrt(d))
    for w, fan_in in ((moe.w_gate, d), (moe.w_up, d), (moe.w_down, ff)):
        for i in range(e):
            init_param_(w[i], generator, 1.0 / math.sqrt(fan_in))
    if hasattr(moe, "dense"):
        init_mlp_(moe.dense, generator)
    return moe


def group_size(tokens: int, cfg: ModelConfig) -> int:
    """Tokens a routing group of a call over ``tokens`` holds: ``router_group_size``, or all of them where it does
    not divide them (the reference's fallback to a single group)."""
    g = min(cfg.router_group_size, tokens)
    return g if tokens % g == 0 else tokens


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows of an expert's buffer for a group of ``tokens``: k·T·capacity_factor / E, a multiple of 4, at least 4."""
    c = math.ceil(cfg.experts_per_token * tokens * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


# ---------------------------------------------------------------------------
# Routing under a data mesh, and what a caller may record of it.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RouteShare:
    """This rank's place among the ranks of ``mesh`` along ``axes``, whose rows, in linear order, make the batch."""

    mesh: object
    axes: tuple

    @property
    def ranks(self) -> int:
        return coll.axes_size(self.mesh, self.axes)

    @property
    def index(self) -> int:
        return coll.linear_index(self.mesh, self.axes)


_SHARE: Optional[RouteShare] = None
_RECORDS: Optional[List[dict]] = None


@contextlib.contextmanager
def routing_over(mesh, axes: Sequence[str]):
    """Inside the block :func:`apply_moe` takes its input as this rank's rows of a batch split over ``axes`` of
    ``mesh`` (every rank of those axes must make the same calls); without a mesh or axes, the block changes
    nothing."""
    global _SHARE
    before = _SHARE
    axes = tuple(axes or ())
    _SHARE = RouteShare(mesh, axes) if mesh is not None and axes and coll.axes_size(mesh, axes) > 1 else None
    try:
        yield
    finally:
        _SHARE = before


@contextlib.contextmanager
def recording():
    """A list that gets, for each :func:`apply_moe` call inside the block, ``{"expert": (N, k), "kept": (N, k)}``
    of the call's N tokens in order: each choice's expert and whether it found room."""
    global _RECORDS
    before, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = before


# ---------------------------------------------------------------------------
# Routing and dispatch.
# ---------------------------------------------------------------------------


def _positions(idx, e, present, share, first, n_groups):
    """Each (token, choice)'s position in its expert's buffer: idx (G, T, k) -> (G, T, k).

    A pass's positions count, in token order, the choices of its own pass
    and start after every choice of the passes before it (the reference's
    running counts); tokens not ``present`` (another rank's) count for
    nothing here, and a shared route starts each pass after the choices
    that earlier ranks make in it.
    """
    g, t, k = idx.shape
    local, counts = [], []
    for i in range(k):  # k passes of a (G, T, E) one-hot keep the peak at T·E a group
        oh = F.one_hot(idx[..., i], e)
        if present is not None:
            oh = oh * present[..., None]
        local.append(torch.gather(oh.cumsum(1), 2, idx[..., i:i + 1])[..., 0] - 1)
        counts.append(oh.sum(1))
    counts = torch.stack(counts, 1)                                    # (G, k, E)
    before = 0
    if share is not None:
        table = counts.new_zeros((n_groups, k, e), dtype=torch.int32)
        table[first:first + g] = counts
        every = coll.gather_axes(table, share.mesh, share.axes)[:, first:first + g].long()  # (ranks, G, k, E)
        before = every[:share.index].sum(0)
        counts = every.sum(0)
    start = counts.cumsum(1) - counts + before                         # (G, k, E)
    rows = torch.arange(g, device=idx.device)[:, None, None]
    passes = torch.arange(k, device=idx.device)[None, None, :]
    return torch.stack(local, -1) + start[rows, passes, idx]


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig, present=None, share: Optional[RouteShare] = None,
          first: int = 0, n_groups: Optional[int] = None):
    """The routing of groups x (G, T, d): (gate, expert, position, keep, dest), each (G, T, k).

    ``gate`` are the renormalised float32 gates, ``expert`` the choices,
    ``position`` each choice's row in its expert's buffer, ``keep`` whether
    it is below the capacity, and ``dest`` its slot ``expert · cap +
    position``, or the sentinel ``E · cap`` when dropped.  ``present``
    (G, T) marks this rank's tokens where its groups hold other ranks' slots
    (zeros); ``share`` then gives the ranks, ``first`` the index of x's
    first group and ``n_groups`` the count of global groups.
    """
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(x.shape[1], cfg)
    with ieee_float32_matmul(x.device):
        logits = x.float() @ p.router                                  # (G, T, E), IEEE float32
    probs = torch.softmax(logits, -1)
    gate, idx = torch.topk(probs, k, dim=-1)                           # descending, as lax.top_k
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    position = _positions(idx, e, present, share, first, n_groups)
    keep = position < cap
    if present is not None:
        keep = keep & present[..., None]
    dest = torch.where(keep, idx * cap + position, e * cap)
    if _RECORDS is not None:
        own = (slice(None),) if present is None else (present,)
        _RECORDS.append({"expert": idx[own].reshape(-1, k), "kept": keep[own].reshape(-1, k)})
    return gate, idx, position, keep, dest


def route_groups(p: MoE, x: torch.Tensor, cfg: ModelConfig, present=None, share: Optional[RouteShare] = None,
                 first: int = 0, n_groups: Optional[int] = None) -> torch.Tensor:
    """Groups x (G, T, d) -> y (G, T, d): the reference's ``_route_group`` on each group (arguments of :func:`route`)."""
    g, t, d = x.shape
    e, cap = cfg.n_experts, capacity(t, cfg)
    gate, _, _, keep, dest = route(p, x, cfg, present, share, first, n_groups)
    # the token table: token ids scattered into (E·cap,) slots, T (the zero row) where no token landed
    table = torch.full((g, e * cap + 1), t, dtype=torch.long, device=x.device)
    ids = torch.arange(t, device=x.device)[None, :, None].expand(dest.shape)
    table = table.scatter_(1, dest.reshape(g, -1), ids.reshape(g, -1))[:, :e * cap]
    grp = torch.arange(g, device=x.device)[:, None]
    x_pad = torch.cat([x, x.new_zeros((g, 1, d))], 1)
    expert_in = x_pad[grp, table].reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    # the batched expert FFN
    act = F.silu if cfg.mlp == "swiglu" else _gelu_tanh
    h = act(torch.bmm(expert_in, p.w_gate)) * torch.bmm(expert_in, p.w_up)
    out = torch.bmm(h, p.w_down).reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    out = torch.cat([out, out.new_zeros((g, 1, d))], 1)

    gathered = out[grp[..., None], dest]                               # (G, T, k, d)
    return torch.einsum("gtkd,gtk->gtd", gathered, (gate * keep).to(x.dtype))


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), routed in groups of ``router_group_size`` tokens, plus the dense residual.

    Inside :func:`routing_over` x is this rank's rows of the global batch,
    and the groups are the global batch's (the module docstring).
    """
    b, s, d = x.shape
    n = b * s
    share = _SHARE
    ranks, index = (1, 0) if share is None else (share.ranks, share.index)
    total = n * ranks
    g = group_size(total, cfg)
    flat = x.reshape(n, d)
    if n % g == 0:  # whole groups: rank-local routing is the reference's
        y = route_groups(p, flat.reshape(-1, g, d), cfg).reshape(b, s, d)
    else:  # this rank's tokens in their slots of the global groups they belong to
        start = index * n
        first, last = start // g, (start + n - 1) // g + 1
        lead = start - first * g
        slots = x.new_zeros(((last - first) * g, d))
        slots[lead:lead + n] = flat
        present = torch.zeros((last - first) * g, dtype=torch.bool, device=x.device)
        present[lead:lead + n] = True
        y = route_groups(p, slots.reshape(-1, g, d), cfg, present.reshape(-1, g), share, first, total // g)
        y = y.reshape(-1, d)[lead:lead + n].reshape(b, s, d)
    if cfg.dense_residual:
        y = y + apply_mlp(p.dense, x, cfg.mlp)
    return y


def aux_load_balance_loss(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss: E · Σ_e (share of top-k choices on e) · (mean probability of e).

    ``transformer.loss_fn`` does not add it, as the reference's does not.
    """
    with ieee_float32_matmul(x.device):
        logits = x.reshape(-1, x.shape[-1]).float() @ p.router
    probs = torch.softmax(logits, -1)
    _, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    frac = F.one_hot(idx, cfg.n_experts).float().mean((0, 1))
    return cfg.n_experts * torch.sum(frac * probs.mean(0))
