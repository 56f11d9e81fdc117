"""90th percentile of the latencies of every request completed in the
window (linear between order statistics), in milliseconds."""
import statistics


def read(ctx):
    lat = [r["latency_s"] for r in ctx.done]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[-1] * 1e3
