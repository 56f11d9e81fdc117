"""Mean time a request spends building views, in ms: over the window's
requests that built one, the summed host time of their ``view:*`` spans
with ``built`` true.  A view span ends after its unit function's one
sync, so it holds the device work.  The window is read from the
program's tracer (``harness.spans``), which keeps 256 traces: a window
of more requests is read over its last ~250.  Nothing when no request
built a view."""
from harness import spans


def read(ctx):
    per_request = []
    for trace in spans.window_traces(ctx):
        built = [s["dur_s"] for s in trace
                 if s["name"].startswith("view:") and s["attrs"].get("built")]
        if built:
            per_request.append(sum(built))
    if not per_request:
        return None
    return sum(per_request) / len(per_request) * 1e3
