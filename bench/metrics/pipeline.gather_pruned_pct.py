"""The share of the join steps' bytes that column liveness leaves out, in
percent: over the ``pipeline.run`` spans of the window's requests (one a
unit's attempt that fit), 100 x sum(pruned_bytes) / sum(pruned_bytes +
slot_bytes).  A run's ``slot_bytes`` is what its join steps gather over
their static capacities, and ``pruned_bytes`` what they would gather
besides over the same capacities had every step kept every column of
both sides: together, what the steps gathered before each one gathered
only the columns its unit reads after it.  A count: it does not move with
the chip's noise.  The window is read from the program's tracer
(``harness.spans``), as ``pipeline.join_live_pct`` reads it.  Nothing
when no run carries ``pruned_bytes`` (a program without liveness)."""
from harness import spans


def read(ctx):
    pruned = gathered = 0
    seen = False
    for trace in spans.window_traces(ctx):
        for s in spans.named(trace, "pipeline.run"):
            a = s["attrs"]
            if "pruned_bytes" in a:
                seen = True
                pruned += a["pruned_bytes"]
                gathered += a["slot_bytes"]
    if not seen or not pruned + gathered:
        return None
    return pruned / (pruned + gathered) * 100.0
