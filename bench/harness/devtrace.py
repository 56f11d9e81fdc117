"""A profiled sub-window: device intervals, idle gaps and kernel times.

``torch.profiler`` records the device's operations (kernels, copies,
fills) with their start and end.  Their union over the sub-window is the
busy time; what lies between is idle, and each idle gap is labelled by
the innermost program span (``repro_torch.obs``) open on the host at the
gap's midpoint.  The profiler's clock is tied to ``time.perf_counter``,
the spans' clock, by one anchor event: the midpoints of its interval on
the two clocks are taken to coincide.
"""
from __future__ import annotations

import collections
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

MAX_TRACE_EVENTS = 50_000
NAME_CHARS = 96


class DeviceProfile:
    """What one profiled sub-window saw, in seconds."""

    def __init__(self, intervals, window, spans, device_ops):
        self.window = window                  # (start_us, end_us)
        self.intervals = intervals            # merged busy intervals (us)
        self.spans = spans                    # [(start_us, end_us, name)]
        self.device_ops = device_ops          # [(name, start_us, end_us)]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals) / 1e6

    def op_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.device_ops:
            out[name[:NAME_CHARS]] += (e - s) / 1e6
        return dict(out)

    def kernel_times(self, parts) -> Dict[str, Tuple[int, float]]:
        """{part: (events, seconds)} of the device ops whose names hold
        each ``part``."""
        out = {p: (0, 0.0) for p in parts}
        for name, s, e in self.device_ops:
            for p in parts:
                if p in name:
                    n, t = out[p]
                    out[p] = (n + 1, t + (e - s) / 1e6)
        return out

    def gaps(self) -> List[Tuple[float, float]]:
        out, cur = [], self.window[0]
        for s, e in self.intervals:
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if cur < self.window[1]:
            out.append((cur, self.window[1]))
        return out

    def host_label(self, t_us: float) -> str:
        inner = None
        for s, e, name in self.spans:
            if s <= t_us < e and (inner is None or s >= inner[0]):
                inner = (s, e, name)
        return inner[2] if inner else "outside the program"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])
        by_label: Dict[str, List[float]] = collections.defaultdict(list)
        for s, e in self.gaps():
            by_label[self.host_label((s + e) / 2)].append((e - s) / 1e6)
        gaps = sorted(((f"{label} ({len(v)} gaps)", sum(v))
                       for label, v in by_label.items()),
                      key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}

    def write_chrome(self, path) -> None:
        events = []
        for name, s, e in self.device_ops[:MAX_TRACE_EVENTS // 2]:
            events.append({"name": name[:NAME_CHARS], "ph": "X",
                           "pid": "device",
                           "tid": 0, "ts": s, "dur": e - s})
        for s, e, name in self.spans[:MAX_TRACE_EVENTS // 2]:
            events.append({"name": name, "ph": "X", "pid": "host",
                           "tid": 0, "ts": s, "dur": e - s})
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"traceEvents": events,
                                    "displayTimeUnit": "ms"}))


def _merge(intervals):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def capture(run: Callable[[], List[List[Dict]]]) -> Optional[DeviceProfile]:
    """Profile ``run()``, which makes the sub-window's requests and returns
    their span lists; ``None`` when the profiler saw no device operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        before = time.perf_counter()
        with record_function("bench.anchor"):
            pass
        after = start = time.perf_counter()
        span_lists = run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        end = time.perf_counter()
    events = prof.events()
    mark = next((e for e in events if e.name == "bench.anchor"), None)
    if mark is None:
        return None
    # the anchor's midpoint on both clocks
    offset = (mark.time_range.start + mark.time_range.end) / 2 \
        - (before + after) / 2 * 1e6
    w0, w1 = start * 1e6 + offset, end * 1e6 + offset
    cuda = torch.autograd.DeviceType.CUDA
    ops = []
    for e in events:
        if getattr(e, "device_type", None) != cuda:
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            ops.append((e.name, s, t))
    if not ops:
        return None
    spans = [(s["start_s"] * 1e6 + offset,
              (s["start_s"] + s["dur_s"]) * 1e6 + offset, s["name"])
             for spans in span_lists for s in spans]
    return DeviceProfile(_merge((s, t) for _, s, t in ops), (w0, w1), spans,
                         sorted(ops, key=lambda o: o[1]))
