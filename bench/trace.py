"""Reading a ``torch.profiler`` trace of a window of requests.

The traced window is a ``bench.window`` range; only what lies inside it
counts.  The device's busy time is the union of the intervals of every
device operation (kernels, copies, fills) in it, so overlapping streams
count once.  An idle gap is charged to the innermost host operation that
was running at its middle: what the host was doing while the device
waited.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "bench.window"
TOP = 10


def _interval(e) -> Tuple[float, float]:
    return float(e.time_range.start) * 1e-6, float(e.time_range.end) * 1e-6


def _is_device(e) -> bool:
    """An operation that ran on the device: not a host range's shadow on the device's timeline
    (``record_function`` ranges appear there too, as user annotations)."""
    return (
        e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith("bench.")
    )


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events, requests: int) -> Dict:
    """busy_s, window_s, kernels, device_ops and idle_gaps of the traced window (seconds)."""
    windows = [_interval(e) for e in events if e.name == WINDOW and e.device_type == torch.autograd.DeviceType.CPU]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = windows[0]
    device, host = [], []
    for e in events:
        s, t = _interval(e)
        if _is_device(e):
            if s >= w0 and s < w1:
                device.append((e.name, max(s, w0), min(t, w1)))
        elif e.device_type == torch.autograd.DeviceType.CPU and s >= w0 and t <= w1 and e.name != WINDOW:
            host.append((s, t, e.name))
    merged = _merge([(s, t) for _, s, t in device])
    busy = sum(t - s for s, t in merged)
    by_op: Dict[str, float] = defaultdict(float)
    kernels = 0
    for name, s, t in device:
        by_op[name] += t - s
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    # idle gaps, each charged to the innermost host op open at its middle: a sweep over the host
    # ops in start order with a stack of the open ones
    host.sort()
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "(no host op)"] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": busy,
        "window_s": w1 - w0,
        "requests": requests,
        "kernels": kernels,
        "device_ops": top(by_op),
        "idle_gaps": top(gaps),
    }


def traced(run_requests, requests: int) -> Dict:
    """Run ``run_requests()`` (``requests`` requests) under the profiler inside a ``bench.window`` range.

    ``run_requests`` is called twice: once with ``warm=True`` (one request, so the profiler's own
    start-up falls outside the window) and once for the window.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_requests(warm=True)
        with record_function(WINDOW):
            run_requests(warm=False)
    t0 = time.perf_counter()
    out = summarize(prof.events(), requests)
    out["read_s"] = time.perf_counter() - t0
    return out
