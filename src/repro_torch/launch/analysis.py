"""What one step costs a rank: FLOPs, bytes, collectives and memory, counted on the run itself.

The counterpart of the JAX package's ``launch/hlo_analysis.py``.  That
module reads XLA's compiled HLO: ``cost_analysis()`` for FLOPs and bytes,
``memory_analysis()`` for the buffers, and a text parse of the partitioned
program for its collectives.  Eager torch has no compiled program, so the
port counts the step as it runs, on meta tensors in the dry-run
(``launch/dryrun.py``) or on real ones (the same count, which
``chip_smoke.py``'s ``launch.card`` phase holds against the card):

* :func:`measure` opens the counters around a step: ``FlopCounterMode`` for
  the FLOPs of torch's own ops, :func:`repro_torch.kernels.ops.counting`
  for the hand-written kernels' launches, operations and bytes (their
  formulas, whatever route runs; ``Measurement.launches``), beside the
  launches the card really made (``Measurement.launched``, from
  :func:`repro_torch.kernels.ops.launch_counts`: empty off the card, and
  equal to ``launches`` on it), :class:`Meter` (a ``TorchDispatchMode`` of the
  port's own) for the bytes of every aten op and the live tensors, keyed by
  storage, and :func:`repro_torch.dist.collectives.recording` for the
  collectives each rank issues;
* :func:`cost_summary` -> FLOPs (torch's ops plus the kernels) and bytes;
  the bytes are unfused: every aten op and kernel reads each tensor operand
  once and writes its result once (views move nothing; an op that writes
  into an operand counts it once, as its result), so a fused program moves
  fewer;
* :func:`memory_summary` -> the peak bytes the rank holds: what was
  resident when the step began (parameters, optimizer state, caches,
  inputs) and the live tensors it makes, at their largest;
* :class:`CollectiveStats` and :func:`collective_stats`: the reference's
  wire model (``hlo_analysis.py:11-16``) for the two collectives the port
  issues, fed from the recorded calls (op, group size g, result bytes b):

      all-gather   operand b/g,  wire b·(g−1)/g   (received payload)
      all-reduce   operand b,    wire 2·b·(g−1)/g (ring: reduce-scatter + all-gather)

Nothing here parses text: the recorded calls take ``parse_collectives``'
place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops

BYTES_NOTE = ("unfused: each aten op and kernel reads every tensor operand once and writes its result once; "
              "views move nothing")


@dataclasses.dataclass
class CollectiveStats:
    ops: Dict[str, int]
    operand_bytes: Dict[str, float]       # per-device operand-volume view
    wire_bytes: Dict[str, float]          # per-device wire-traffic view

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())

    def merged(self, other: "CollectiveStats", scale: float = 1.0) -> "CollectiveStats":
        out = CollectiveStats(dict(self.ops), dict(self.operand_bytes), dict(self.wire_bytes))
        for k in other.ops:
            out.ops[k] = out.ops.get(k, 0) + int(other.ops[k] * scale)
            out.operand_bytes[k] = out.operand_bytes.get(k, 0.0) + other.operand_bytes[k] * scale
            out.wire_bytes[k] = out.wire_bytes.get(k, 0.0) + other.wire_bytes[k] * scale
        return out

    def as_record(self) -> dict:
        return {"ops": self.ops, "operand_bytes": self.operand_bytes, "wire_bytes": self.wire_bytes,
                "total_wire_bytes": self.total_wire_bytes}


def collective_stats(calls: Iterable[Tuple[str, int, int]]) -> CollectiveStats:
    """The wire model over recorded ``(op, group size, result bytes)`` calls; a group of one moves nothing."""
    stats = CollectiveStats({}, {}, {})
    for kind, g, b in calls:
        if g <= 1:
            continue
        b = float(b)
        if kind == "all-gather":
            op_b, wire_b = b / g, b * (g - 1) / g
        elif kind == "all-reduce":
            op_b, wire_b = b, 2 * b * (g - 1) / g
        else:
            raise ValueError(f"the port issues all-reduce and all-gather only, not {kind!r}")
        stats.ops[kind] = stats.ops.get(kind, 0) + 1
        stats.operand_bytes[kind] = stats.operand_bytes.get(kind, 0.0) + op_b
        stats.wire_bytes[kind] = stats.wire_bytes.get(kind, 0.0) + wire_b
    return stats


class Meter(TorchDispatchMode):
    """Bytes of every aten op, and the bytes of live storages at their peak.

    A storage is counted from the first op that makes or reads it until its
    last reference dies (a weak reference's callback); :meth:`track` counts
    one that no op has seen yet (the step's resident tensors, a kernel's
    result).  Collectives (``c10d``) move wire bytes, counted elsewhere.
    """

    _FREE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, tuple] = {}

    def track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type not in ("meta", "cuda", "cpu"):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        size = st.nbytes()
        self._refs[key] = (weakref.ref(st, lambda _, key=key: self._free(key)), size)
        self.live += size
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        ref = self._refs.pop(key, None)
        if ref is not None:
            self.live -= ref[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            return out
        for t in tree_leaves(out):
            self.track(t)
        if func.is_view or func._schema.name.split("::")[-1] in self._FREE:
            return out
        written = {a.name for a in func._schema.arguments if a.alias_info is not None and a.alias_info.is_write}
        reads = [v for a, v in zip(func._schema.arguments, args) if a.name not in written]
        reads += [v for k, v in kwargs.items() if k not in written]
        for t in tree_leaves(reads):
            if isinstance(t, torch.Tensor):
                self.track(t)
                self.bytes += t.numel() * t.element_size()
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


@dataclasses.dataclass
class Measurement:
    """What :func:`measure` counted over one block."""

    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    launched: Dict[str, int] = dataclasses.field(default_factory=dict)
    calls: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)
    resident_bytes: int = 0
    peak_bytes: int = 0
    seconds: float = 0.0

    @property
    def collectives(self) -> CollectiveStats:
        return collective_stats(self.calls)


@contextlib.contextmanager
def measure(resident: Iterable = ()):
    """Count the block: yields a :class:`Measurement`, filled in when the block ends.

    ``resident`` holds the tensors (any tree of them; a module stands for its
    parameters and buffers) the rank holds when the step starts, to be
    counted live from the start.
    """
    res = Measurement()
    meter = Meter()
    for leaf in tree_leaves(list(resident)):
        for t in (list(leaf.parameters()) + list(leaf.buffers())) if isinstance(leaf, torch.nn.Module) else [leaf]:
            meter.track(t)
    res.resident_bytes = meter.live
    before = ops.launch_counts()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, coll.recording() as calls, \
            ops.counting(on_output=meter.track) as kernels, meter:
        yield res
    res.seconds = time.perf_counter() - t0
    res.flops = {"aten": float(flops.get_total_flops()), "kernels": kernels.total_ops}
    res.bytes = {"aten": meter.bytes, "kernels": kernels.total_bytes}
    res.kernels = {k: {"calls": kernels.calls[k], "flops": kernels.ops[k], "bytes": kernels.bytes[k]}
                   for k in kernels.calls}
    res.launches = dict(kernels.launches)
    res.launched = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    res.calls = list(calls)
    res.peak_bytes = meter.peak


def cost_summary(m: Measurement) -> Dict[str, object]:
    """FLOPs (torch's ops by ``FlopCounterMode`` plus the kernels' formulas) and unfused bytes, a rank."""
    return {"flops": m.flops["aten"] + m.flops["kernels"], "bytes": m.bytes["aten"] + m.bytes["kernels"],
            "aten_flops": m.flops["aten"], "kernel_flops": m.flops["kernels"], "kernel_bytes": m.bytes["kernels"],
            "kernels": m.kernels, "launches": m.launches, "bytes_note": BYTES_NOTE}


def memory_summary(m: Measurement) -> Dict[str, float]:
    """The bytes a rank holds: resident at the start, and at the peak of the step's live tensors."""
    return {"resident_bytes": float(m.resident_bytes), "peak_bytes": float(m.peak_bytes),
            "temp_peak_bytes": float(m.peak_bytes - m.resident_bytes)}


def analyze(m: Measurement) -> dict:
    """One record's ``{"memory", "cost", "collectives"}``."""
    return {"memory": memory_summary(m), "cost": cost_summary(m), "collectives": m.collectives.as_record()}
