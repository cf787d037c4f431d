"""The traced part of a window: a ``torch.profiler`` run held in memory, and
its reduction to the counts and times that the per-layer metrics read.

Only kernels count as device work: copies and sets between host and
device (``Memcpy``, ``Memset``) are left out of the busy time and of the
launch count. A custom op's device time is the time of the kernels
launched while it ran, its children's included, as the profiler links
them to the op (``FunctionEvent.device_time_total``).
"""

from __future__ import annotations

import time
from bisect import bisect_right
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

NOT_KERNELS = ("Memcpy", "Memset")
CONV_OPS = ("aten::convolution",)
NAME_CHARS = 100  # kernel and op names in the breakdown are cut to this


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted intervals covering ``spans`` (the union arithmetic of
    the port's ``utils/profiling._union_seconds``)."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def name_points(points: List[float], ops: List[Tuple[float, float, str]]) -> List[str]:
    """For each time in ``points`` (sorted), the host op running then: the
    innermost op of ``ops`` (start, end, name; properly nested, one
    thread) that covers it, as "outermost/innermost", or "(no op)"."""
    ops = sorted(ops)
    starts = [o[0] for o in ops]
    names = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for p in points:
        j = bisect_right(starts, p)
        while i < j:
            o = ops[i]
            while stack and stack[-1][1] <= o[0]:
                stack.pop()
            stack.append(o)
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        if not stack:
            names.append("(no op)")
        elif len(stack) == 1:
            names.append(stack[0][2])
        else:
            names.append(f"{stack[0][2]}/{stack[-1][2]}")
    return names


def _device_total(e) -> float:
    """An op's device time in us, its children's included."""
    t = getattr(e, "device_time_total", None)
    return float(t if t is not None else e.cuda_time_total)


def summarize(prof, ops: Iterable[str] = ()) -> dict:
    """-> launches, busy seconds, conv seconds, per-op device seconds and
    calls for ``ops``, and the breakdown (top kernels, idle gaps by host op)."""
    from torch.autograd import DeviceType

    kernels, host = [], defaultdict(list)
    conv_us, op_us, op_calls = 0.0, Counter(), Counter()
    ops = tuple(ops)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(NOT_KERNELS):
                kernels.append((e.time_range.start, e.time_range.end, e.name))
            continue
        host[e.thread].append((e.time_range.start, e.time_range.end, e.name))
        if e.name in CONV_OPS:
            conv_us += _device_total(e)
        elif e.name in ops:
            op_us[e.name] += _device_total(e)
            op_calls[e.name] += 1
    by_kernel = Counter()
    for s, e, n in kernels:
        by_kernel[n[:NAME_CHARS]] += (e - s) / 1e6
    busy = merged([(s, e) for s, e, _ in kernels])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    main = max(host.values(), key=len) if host else []
    names = name_points([(a + b) / 2 for a, b in gaps], main)
    by_gap = Counter()
    for (a, b), n in zip(gaps, names):
        by_gap[n[:NAME_CHARS]] += (b - a) / 1e6
    return {
        "launches": len(kernels),
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "conv_s": conv_us / 1e6,
        "op_s": {k: v / 1e6 for k, v in op_us.items()},
        "op_calls": dict(op_calls),
        "breakdown": {"device_ops": [[n, s] for n, s in by_kernel.most_common(10)],
                      "idle_gaps": [[n, s] for n, s in by_gap.most_common(10)]},
    }


class Tracer:
    """Profiles the part of a window between ``start`` and ``stop``; without
    ``enabled`` both do nothing. ``start`` is called at most once."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled, self.device = enabled, device
        self.prof = None
        self.wall_s: Optional[float] = None
        self._t0 = 0.0
        self.active = False

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.active = False

    def summary(self, ops: Iterable[str] = ()) -> Optional[Dict]:
        if self.prof is None or self.wall_s is None:
            return None
        s = summarize(self.prof, ops)
        s["window_s"] = self.wall_s
        return s
