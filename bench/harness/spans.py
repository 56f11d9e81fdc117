"""The program's spans of the window's requests.

The client opens one ``bench.request`` root span a request, and the
program's spans nest under it in ``repro_torch.obs.TRACER``.  A trace
belongs to the window when its root starts between the first completed
request's start, less 1 ms (the root opens just before the request's
clock starts), and the last one's end.  That leaves out the warm-up
requests and the profiled and recorded requests after the window.  The
tracer keeps the newest 256 traces, so a window of more requests (about
300 in a ``session`` window) is read over its last ~250.
"""
from __future__ import annotations

from typing import Dict, List

ROOT = "bench.request"
SLACK_S = 1e-3


def window_traces(ctx) -> List[List[Dict]]:
    """Each window request's spans, oldest first; ``ctx.tracer`` when the
    context has one, else the program's tracer."""
    done = ctx.done
    if not done:
        return []
    tracer = getattr(ctx, "tracer", None)
    if tracer is None:
        from repro_torch import obs

        tracer = obs.TRACER
    lo, hi = done[0]["start"] - SLACK_S, done[-1]["end"]
    out = []
    for trace_id in tracer.trace_ids():
        spans = tracer.get(trace_id) or []
        root = next((s for s in spans
                     if not s["parent"] and s["name"] == ROOT), None)
        if root is not None and lo <= root["start_s"] <= hi:
            out.append(spans)
    return out


def named(trace: List[Dict], name: str) -> List[Dict]:
    """The spans of one trace called ``name``."""
    return [s for s in trace if s["name"] == name]
