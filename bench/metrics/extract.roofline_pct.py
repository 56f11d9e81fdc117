"""The whole request's share of its byte roofline, in percent.

A request's least bytes: each column its edge queries read (join keys,
``src`` and ``dst``) and each vertex column (id and props) read once from
its table, and each edge (two int32) and vertex column written once; over
3.35 TB/s, divided by the window's mean request time.  The same logical
work whatever implements it.
"""
from harness import roofline


def read(ctx):
    done = ctx.done
    model, rows = ctx.config["model"], ctx.rows
    read_cols = set()
    for e in model["edges"]:
        tables = {r["alias"]: r["table"] for r in e["relations"]}
        refs = [e["src_col"], e["dst_col"]]
        for j in e["joins"]:
            refs += [s.strip() for s in j.split("==")]
        for ref in refs:
            alias, _, col = ref.partition(".")
            read_cols.add((tables[alias], col))
    written = 0
    for v in model["vertices"]:
        cols = [v["id_col"], *v.get("props", ())]
        read_cols.update((v["table"], c) for c in cols)
        written += 4 * len(cols) * rows[v["table"]]
    nbytes = sum(4 * rows[t] for t, _ in read_cols) + written
    edges = sum(r["edges"] for r in done) / len(done)
    nbytes += 8 * edges
    mean_s = sum(r["latency_s"] for r in done) / len(done)
    return roofline.least_s(nbytes) / mean_s * 100.0
