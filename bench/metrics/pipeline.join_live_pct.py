"""The share of the bytes the join steps gather that are live rows, in
percent: over the ``pipeline.run`` spans of the window's requests (one a
unit's attempt that fit), 100 x sum(live_bytes) / sum(slot_bytes).  A
run's ``slot_bytes`` is what its join steps gather over their static
capacities, and ``live_bytes`` the part that holds rows (each step's
exact requirement times the bytes of one of its output rows).  A count:
it does not move with the chip's noise.  The window is read from the
program's tracer (``harness.spans``), which keeps 256 traces: a window
of more requests is read over its last ~250.  Nothing when no run
carries the bytes (a program without this accounting)."""
from harness import spans


def read(ctx):
    live = slots = 0
    for trace in spans.window_traces(ctx):
        for s in spans.named(trace, "pipeline.run"):
            a = s["attrs"]
            if "slot_bytes" in a:
                live += a["live_bytes"]
                slots += a["slot_bytes"]
    if not slots:
        return None
    return live / slots * 100.0
