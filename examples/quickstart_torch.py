"""Quickstart: build a graph model with the fluent builder, open an
ExtractionEngine session over TPC-DS, watch the second request hit the
plan cache and reuse the materialized view built by the first, run graph
analytics on the extracted graph without leaving the session — then
mutate the database and watch ``refresh()`` absorb the change through
delta propagation instead of paying another cold extract, and finally
pull the request's span tree from the always-on tracer to see where the
time went.  The port (``repro_torch``) of ``examples/quickstart.py``: the
same steps and printed lines, on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np                                                      # noqa: E402

from repro_torch.api import (ExtractionEngine, model_from_spec,         # noqa: E402
                             model_to_spec)
from repro_torch.core import GraphModel, plan_cost                      # noqa: E402
from repro_torch.data import make_tpcds                                 # noqa: E402
from repro_torch.relational.table import host                          # noqa: E402


def recommendation_model() -> GraphModel:
    """Figure 11(a) built fluently: no hand-assembled dataclasses."""
    return (
        GraphModel.builder("recommendation_store")
        .vertex("Customer", table="customer", id_col="c_id",
                props=("c_prop",))
        .vertex("Item", table="item", id_col="i_id", props=("i_price",))
        .vertex("Promotion", table="promotion", id_col="p_id")
        .edge("Buy", src="Customer", dst="Item",
              relations=[("C", "customer"), ("F", "store_sales"),
                         ("I", "item")],
              joins=["C.c_id == F.c_sk", "F.i_sk == I.i_id"])
        .edge("Co-pur", src="Customer", dst="Customer",
              relations=[("C1", "customer"), ("F1", "store_sales"),
                         ("I", "item"), ("F2", "store_sales"),
                         ("C2", "customer")],
              joins=["C1.c_id == F1.c_sk", "F1.i_sk == I.i_id",
                     "I.i_id == F2.i_sk", "F2.c_sk == C2.c_id"],
              src_col="C1.c_id", dst_col="C2.c_id")
        .edge("Same-pro", src="Customer", dst="Customer",
              relations=[("C1", "customer"), ("F1", "store_sales"),
                         ("P", "promotion"), ("F2", "store_sales"),
                         ("C2", "customer")],
              joins=["C1.c_id == F1.c_sk", "F1.p_sk == P.p_id",
                     "P.p_id == F2.p_sk", "F2.c_sk == C2.c_id"],
              src_col="C1.c_id", dst_col="C2.c_id")
        .build()
    )


def main(sf: int = 2, device=None):
    print(f"== 1. synthesize a TPC-DS-shaped database (SF={sf}) ==")
    db = make_tpcds(sf=sf, seed=0, device=device)
    for name, st in sorted(db.stats.items()):
        print(f"   {name:<16} {st.rows:>8} rows")

    print("\n== 2. the graph model, via the fluent builder ==")
    model = recommendation_model()
    for e in model.edges:
        tables = " |><| ".join(r.table for r in e.query.relations)
        print(f"   {e.label:<10} = {tables}")
    print(f"   (serializable: {len(model_to_spec(model)['edges'])} edge "
          "specs via model_to_spec)")

    print("\n== 3. open an extraction session ==")
    engine = ExtractionEngine(db)

    print("\n== 4. request 1 (cold): Algorithm 2 plans, views materialize ==")
    r1 = engine.extract(model, verbose=True)
    print(r1.plan.describe())
    print(f"   estimated cost: {plan_cost(db.snapshot(), r1.plan):.3g} byte-units")
    print(f"   plan {r1.timings.plan_s:.3f}s  extract {r1.timings.extract_s:.3f}s  "
          f"built={list(r1.provenance.views_built)}")

    print("\n== 5. request 2 (warm): plan-cache hit, views reused ==")
    r2 = engine.extract(model)
    sizes = {k: int(v.num_rows()) for k, v in r2.edges.items()}
    print(f"   plan {r2.timings.plan_s:.3f}s  extract {r2.timings.extract_s:.3f}s  "
          f"cache_hit={r2.provenance.plan_cache_hit}  "
          f"reused={list(r2.provenance.views_reused)}")
    print(f"   edges={sizes}")
    print(f"   warm speedup: {r1.timings.total_s / r2.timings.total_s:.2f}x")

    print("\n== 6. why that plan? EXPLAIN / EXPLAIN ANALYZE ==")
    # explain() is free — it reports the plan (join orders, MV-vs-OJ
    # decision with cost numbers, pow-2 capacities, executable state)
    # without running anything; explain_analyze() adds actual rows and
    # capacity utilization per join step, recycled from the overflow
    # check's existing host sync — zero extra device round trips
    report = engine.explain_analyze(model)
    print("\n".join("   " + line
                    for line in report.render_text().splitlines()))
    print(f"   sharing speedup per cost model: "
          f"{report.sharing_speedup:.2f}x  "
          "(POST /v1/explain on a live server)")

    print("\n== 7. analytics without leaving the session ==")
    csr = r2.graph_view()
    print(f"   vertices={csr.num_vertices}  edge_counts={csr.edge_counts}")
    pr = engine.analyze(model, algorithm="pagerank", label="Buy", iters=15)
    assert pr.provenance.csr_cache_hit, "graph_view already built this CSR"
    ranks = host(pr.values)
    lo, hi = csr.vertex_ranges["Item"]
    top = lo + np.argsort(ranks[lo:hi])[::-1][:3]
    ids = host(csr.vertex_ids)
    print(f"   pagerank (csr_cache_hit={pr.provenance.csr_cache_hit}, "
          f"analyze {pr.timings.analyze_s:.3f}s)")
    for v in top:
        print(f"   hot item id={int(ids[v])}  rank={ranks[v]:.5f}")
    wcc = engine.analyze(model, algorithm="wcc")
    n_comp = len(np.unique(host(wcc.values)))
    print(f"   weakly connected components: {n_comp}")

    print("\n== 8. the database mutates; refresh() propagates the deltas ==")
    rng = np.random.default_rng(42)
    k = max(8, 4 * sf)
    base = int(db.tables["store_sales"]["rid"].max()) + 1
    db.insert_rows(
        "store_sales",
        rid=np.arange(base, base + k, dtype=np.int32),
        c_sk=rng.integers(0, db.stats["customer"].rows, k).astype(np.int32),
        i_sk=rng.integers(0, db.stats["item"].rows, k).astype(np.int32),
        p_sk=rng.integers(0, db.stats["promotion"].rows, k).astype(np.int32),
        o_sk=rng.integers(0, 4, k).astype(np.int32))
    db.delete_where("store_sales", "rid", "<", k // 2)
    print(f"   +{k} sales inserted, rid < {k // 2} deleted "
          f"(changelog epoch {db.epoch})")

    r3 = engine.refresh(model)
    rp = r3.refresh
    print(f"   refresh path={rp.path}  churn={rp.churn:.4f}  "
          f"views_maintained={list(rp.views_maintained)}  "
          f"extract {r3.timings.extract_s:.3f}s")

    # parity: a cold engine over the mutated tables answers identically
    from repro_torch.core.database import Database
    cold = ExtractionEngine(Database(dict(db.tables)))
    pr_refreshed = engine.analyze(model, algorithm="pagerank", label="Buy",
                                  iters=15, auto_refresh=True)
    pr_cold = cold.analyze(model, algorithm="pagerank", label="Buy",
                           iters=15)
    same = np.allclose(host(pr_refreshed.values), host(pr_cold.values),
                       rtol=1e-5, atol=1e-7)
    print(f"   refreshed analyze matches cold engine: {same}")

    print("\n== 9. no model at all? discover one from the raw tables ==")
    disc = engine.discover()
    print(f"   {disc.stats['accepted_fks']} FKs inferred, validated by "
          f"{disc.stats['containment_checks']} sampled containment checks "
          f"(all_compiled={disc.stats['all_compiled']})")
    for fk in disc.fks[:3]:
        print(f"   fk   {fk.describe()}")
    for e in disc.edges[:3]:
        route = " |><| ".join([e.relations[0][1]]
                              + [r[1] for r in e.relations[1:]])
        print(f"   edge {e.label:<24} = {route}  (conf={e.confidence:.2f})")
    proposed = model_from_spec(disc.model_spec(top=3))
    rd = engine.extract(proposed)
    sizes = {k: int(v.num_rows()) for k, v in rd.edges.items()}
    print(f"   accepted top-3 spec, extracted: {sizes}")
    pr_disc = engine.analyze(proposed, algorithm="degree_stats")
    print(f"   degree_stats over the discovered graph: "
          f"{ {k: round(float(host(v).mean()), 2) for k, v in pr_disc.values.items()} }")

    print("\n== 10. where did the time go? ask the tracer ==")
    from repro_torch import obs
    _, bd = obs.traced_call("quickstart.extract", engine.extract, model)
    print(f"   warm extract: wall {bd['wall_s'] * 1e3:.1f}ms = "
          f"plan {bd['plan_s'] * 1e3:.1f}ms + "
          f"compile {bd['compile_s'] * 1e3:.1f}ms + "
          f"execute {bd['execute_s'] * 1e3:.1f}ms + "
          f"transfer {bd['transfer_s'] * 1e3:.1f}ms "
          f"(coverage {bd['coverage']:.0%})")
    tid = obs.TRACER.trace_ids()[-1]
    for s in sorted(obs.TRACER.get(tid), key=lambda s: s["start_s"]):
        if not s["detail"]:
            print(f"   span {s['name']:<24} {s['dur_s'] * 1e3:8.2f}ms  "
                  f"[{s['category'] or 'other'}]")
    hits = obs.REGISTRY.value("engine_cache_events_total",
                              cache="plans", event="hits")
    print(f"   plan-cache hits this session: {hits:.0f}  "
          "(full registry: obs.REGISTRY.snapshot(), or GET /v1/metrics "
          "on a live server)")

    print("\n== 11. durability: crash, recover, bit-identical graphs ==")
    import shutil
    import tempfile

    from repro_torch.durability import recover_database, write_manifest
    durable = tempfile.mkdtemp(prefix="quickstart_durable_")
    write_manifest(durable, db, {}, {})   # checkpoint the current epoch
    db.attach_wal(durable)                # every mutation is WAL-first now
    base = int(db.tables["store_sales"]["rid"].max()) + 1
    db.insert_rows(
        "store_sales",
        rid=np.arange(base, base + 64, dtype=np.int32),
        c_sk=np.arange(64, dtype=np.int32),
        i_sk=np.arange(64, dtype=np.int32),
        p_sk=np.zeros(64, dtype=np.int32),
        o_sk=np.zeros(64, dtype=np.int32))
    want = engine.refresh(model).graph.fingerprint()
    db.detach_wal()
    del db, engine                        # "crash": every object is gone

    recovered, report = recover_database(durable, Database(), device=device)
    print(f"   recovered: {report.summary()}")
    got = ExtractionEngine(recovered).extract(model).graph.fingerprint()
    assert got == want, f"{got} != {want}"
    print(f"   fingerprint parity after checkpoint + WAL replay: {got}")
    print("   (GraphService(db, models, durable_dir=...) does all of this "
          "on restart, including adopting checkpointed graphs)")
    shutil.rmtree(durable, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host; default: the CUDA card")
    main(device=ap.parse_args().device)
