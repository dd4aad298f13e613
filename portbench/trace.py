"""Reduction of a ``torch.profiler`` trace of the measured window to the
device's busy time, device time by kernel or copy name, and idle gaps
by the host span they fell in.

Busy time is the union of CUDA kernel and copy intervals, as
tools/profile_torch_main_path.py takes it (copied here so that the
yardstick stays with the benchmark). Imports nothing of the port.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

#: the benchmark's own range around the measured window
WINDOW = "portbench.window"


class DeviceTrace:
    """What the readers take from a trace: ``busy_s``, ``window_s``,
    ``by_name`` (device seconds by kernel or copy name), ``gaps_by_span``
    (idle device seconds by the innermost host span open at the time) and
    :meth:`seconds` (device seconds of names holding any of some parts)."""

    def __init__(self, by_name: dict, busy_s: float, window_s: float, gaps_by_span: dict):
        self.by_name = by_name
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps_by_span = gaps_by_span

    def seconds(self, parts) -> float:
        return sum(s for name, s in self.by_name.items() if any(p in name for p in parts))

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps_by_span.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[name[:120], s] for name, s in top],
                "idle_gaps": [[name, s] for name, s in gaps]}


def _union(intervals):
    """Merged, sorted intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(spans, t0, t1):
    """Elementary segments of [t0, t1]: (boundaries, name of the innermost
    span over each segment, or None)."""
    cuts = sorted({t0, t1, *(s for s, _, _ in spans), *(e for _, e, _ in spans)})
    cuts = [c for c in cuts if t0 <= c <= t1]
    names = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        best = None
        for s, e, name in spans:
            # innermost: the latest start, then the earliest end
            if s <= mid < e and (best is None or (s, -e) > best[:2]):
                best = (s, -e, name)
        names.append(best[2] if best else None)
    return cuts, names


def reduce(events, span_names, device_type_cuda, device_type_cpu) -> DeviceTrace:
    """``events``: the profiler's ``events()``; ``span_names``: names of
    host ranges (the port's spans and the benchmark's) to attribute idle
    gaps to. Times are taken within the benchmark's window range."""
    window = None
    spans, device, by_name = [], [], defaultdict(float)
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == device_type_cpu:
            if ev.name == WINDOW:
                window = (start, end)
            elif ev.name in span_names:
                spans.append((start, end, ev.name))
        elif (ev.device_type == device_type_cuda and not getattr(ev, "is_user_annotation", False)
              and ev.name not in span_names and ev.name != WINDOW):
            device.append((start, end, ev.name))
    if window is None:
        raise RuntimeError("the trace has no window range")
    w0, w1 = window
    intervals = []
    for start, end, name in device:
        start, end = max(start, w0), min(end, w1)
        if end > start:
            intervals.append((start, end))
            by_name[name] += (end - start) / 1e6
    busy = _union(intervals)
    busy_us = sum(e - s for s, e in busy)
    gaps, last = [], w0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    cuts, names = _innermost(spans, w0, w1)
    gaps_by_span = defaultdict(float)
    for g0, g1 in gaps:
        i = max(bisect.bisect_right(cuts, g0) - 1, 0)
        while i < len(names) and cuts[i] < g1:
            lo, hi = max(g0, cuts[i]), min(g1, cuts[i + 1])
            if hi > lo:
                gaps_by_span[names[i] or "outside any span"] += (hi - lo) / 1e6
            i += 1
    return DeviceTrace(dict(by_name), busy_us / 1e6, (w1 - w0) / 1e6, dict(gaps_by_span))
