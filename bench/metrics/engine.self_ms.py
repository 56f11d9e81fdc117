"""Mean of a request's wall time less its plan, execute and vertices
times: engine construction (fresh sessions), cache bookkeeping and the
result's assembly, in ms."""


def read(ctx):
    vals = [r["latency_s"] - r["plan_s"] - r["extract_s"] - r["vertices_s"]
            for r in ctx.done if r["vertices_s"] is not None]
    if not vals:
        return None
    return sum(vals) / len(vals) * 1e3
