"""Mean device time of a request's join steps, in ms: over the window's
requests, the summed ``device_s`` of their ``pipeline.join`` spans (CUDA
events at each step's entry and exit, resolved after the unit's sync).
The window is read from the program's tracer (``harness.spans``), which
keeps 256 traces: a window of more requests is read over its last ~250.
Nothing when no join step carries a device time (a program without
device-timed spans)."""
from harness import spans


def read(ctx):
    per_request = []
    for trace in spans.window_traces(ctx):
        times = [s["attrs"]["device_s"]
                 for s in spans.named(trace, "pipeline.join")
                 if "device_s" in s["attrs"]]
        if times:
            per_request.append(sum(times))
    if not per_request:
        return None
    return sum(per_request) / len(per_request) * 1e3
