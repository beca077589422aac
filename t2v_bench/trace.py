"""A traced window: `torch.profiler` over CPU ops and the card's kernels,
reduced to what the per-layer readers and the result line take.

* busy: the union of every device interval (kernels, copies, memsets) in
  the window; the idle share is 1 - busy / window.
* kernels: the kernels launched in the window (copies and memsets left
  out), and device seconds by kernel name.
* breakdown: the ten kernel families (`families.FAMILIES`) that took most
  device time, and the ten longest idle gaps, each named by the innermost
  CPU op running at its middle (`host idle` when none was).
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import List, Tuple

import torch

from .families import family


class Window:
    """Start with `start()` and end with `stop()` on the thread that
    launches the window's work, each at a device-synchronised boundary."""

    def __init__(self):
        self.prof = None
        self.t0 = self.seconds = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self.seconds = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> dict:
        return summarize(self.prof.events(), self.seconds)


def _union(intervals: List[Tuple[float, float]]):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, window_s: float) -> dict:
    device, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            device.append((tr.start, tr.end, e.name))
        elif not getattr(e, "is_user_annotation", False):
            host.append((tr.start, tr.end, e.name))
    by_name = collections.Counter()
    kernels = 0
    for a, b, name in device:
        by_name[name] += (b - a) / 1e6
        kernels += not name.startswith(("Memcpy", "Memset"))
    busy = _union([(a, b) for a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) / 1e6
    families = collections.Counter()
    for name, s in by_name.items():
        families[family(name)] += s
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        best = None
        for h in host[:bisect.bisect_right(starts, mid)]:
            if h[1] >= mid and (best is None or h[1] - h[0]
                                < best[1] - best[0]):
                best = h
        named.append([best[2] if best else "host idle", length / 1e6])
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "kernel_seconds": dict(by_name),
            "breakdown": {"device_ops": [[k, v] for k, v in
                                         families.most_common(10)],
                          "idle_gaps": named}}


def seconds_matching(summary: dict, pattern) -> float:
    """Device seconds of the kernels whose names match `pattern`."""
    return sum(s for name, s in summary["kernel_seconds"].items()
               if pattern.search(name))

