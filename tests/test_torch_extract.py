"""The port's extraction path against the JAX package, on the CPU.

Same-seed databases, plans, compiled and eager edge bags, the overflow
retry, the forced kernel path and the engine's warm-request provenance
must all agree exactly with ``repro``: digests and fingerprints are equal
strings, stats equal integer for integer, plans equal ``describe()`` and
``plan_cost``.  Databases stay at sf=1 / scale=1; each JAX result is
computed once per module.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.database as jdb
import repro.core.extract as jext
import repro.core.pipeline as jpipe
import repro.core.planner as jplan
import repro.data as jdata
import repro.relational.ops as jops
import repro_torch.api as tapi
import repro_torch.core.database as tdb
import repro_torch.core.extract as text
import repro_torch.core.pipeline as tpipe
import repro_torch.core.planner as tplan
import repro_torch.data as tdata
import repro_torch.relational.ops as tops

MODELS = {
    "fraud": ("tpcds", lambda d: d.fraud_model("store")),
    "recommendation": ("tpcds", lambda d: d.recommendation_model("store")),
    "combined": ("tpcds", lambda d: d.combined_model()),
    "dblp": ("dblp", lambda d: d.dblp_model()),
    "imdb": ("imdb", lambda d: d.imdb_model()),
}
MAKERS = {"tpcds": ("make_tpcds", dict(sf=1, seed=0)),
          "dblp": ("make_dblp", dict(scale=1, seed=1)),
          "imdb": ("make_imdb", dict(scale=1, seed=2))}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_executables_cold():
    """Empty the JAX package's process-wide executable store after this
    module: its own tests count the compiles of a cold request, and may
    run next in the same worker process."""
    yield
    jpipe.clear_executable_cache()


@pytest.fixture(scope="module")
def dbs():
    """{name: (JAX database, port database)}, same seeds."""
    out = {}
    for name, (fn, kw) in MAKERS.items():
        out[name] = (getattr(jdata, fn)(**kw),
                     getattr(tdata, fn)(device="cpu", **kw))
    return out


@pytest.fixture(scope="module")
def jax_digests(dbs):
    """JAX compiled-pipeline edge digests per model, computed on demand."""
    memo = {}

    def get(model_name):
        if model_name not in memo:
            db_name, mk = MODELS[model_name]
            jd = dbs[db_name][0]
            model = mk(jdata)
            plan = jext.plan_queries(jd.snapshot(), model.queries(),
                                     "extgraph")
            edges = jext.run_plan(jd.snapshot(), plan,
                                  compiler=jpipe.PipelineCompiler())[0]
            memo[model_name] = {k: jops.table_digest(t)
                                for k, t in edges.items()}
        return memo[model_name]
    return get


def _digests(edges):
    return {k: tops.table_digest(t) for k, t in edges.items()}


def _port_plan(dbs, model_name, method="extgraph"):
    db_name, mk = MODELS[model_name]
    td = dbs[db_name][1]
    model = mk(tdata)
    return td, model, text.plan_queries(td.snapshot(), model.queries(),
                                        method)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_same_seed_tables_and_stats(dbs, name):
    jd, td = dbs[name]
    assert list(td.tables) == list(jd.tables)
    for t in jd.tables:
        assert tops.table_digest(td.tables[t]) == \
            jops.table_digest(jd.tables[t]), t
        assert dataclasses.asdict(td.stats[t]) == \
            dataclasses.asdict(jd.stats[t]), t
    assert td.fingerprint() == jd.fingerprint()
    assert td.total_bytes() == jd.total_bytes()


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_from_numpy_tables_carries_jax_database(dbs, name):
    jd, td = dbs[name]
    host = {t: {**{c: np.asarray(tab[c]) for c in tab.columns},
                "valid": np.asarray(tab.valid)}
            for t, tab in jd.tables.items()}
    carried = tdb.from_numpy_tables(host, device="cpu")
    for t, tab in jd.tables.items():
        assert carried.tables[t].capacity == tab.capacity
        assert tops.table_digest(carried.tables[t]) == jops.table_digest(tab)
        for c in tab.columns:
            assert str(carried.tables[t][c].dtype) == f"torch.{tab[c].dtype}"
    assert carried.fingerprint() == jd.fingerprint()


@pytest.mark.parametrize("model_name", sorted(MODELS))
@pytest.mark.parametrize("method", ["extgraph", "extgraph-oj", "extgraph-mv"])
def test_planner_parity(dbs, model_name, method):
    db_name, mk = MODELS[model_name]
    jd, td = dbs[db_name]
    jp = jext.plan_queries(jd.snapshot(), mk(jdata).queries(), method)
    tp = text.plan_queries(td.snapshot(), mk(tdata).queries(), method)
    assert tp.describe() == jp.describe()
    assert tplan.plan_cost(td, tp) == jplan.plan_cost(jd, jp)


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_compiled_and_eager_match_jax(dbs, jax_digests, model_name):
    td, _, plan = _port_plan(dbs, model_name)
    want = jax_digests(model_name)
    compiled = text.run_plan(td.snapshot(), plan,
                             compiler=tpipe.PipelineCompiler(device="cpu"))[0]
    assert _digests(compiled) == want
    eager = text.run_plan(td.snapshot(), plan)[0]
    assert _digests(eager) == want
    for t in compiled.values():
        assert t["src"].dtype == torch.int32 and t["dst"].dtype == torch.int32


@pytest.mark.parametrize("model_name,method", [
    ("fraud", "extgraph"), ("recommendation", "extgraph-oj")])
def test_forced_overflow_retry(dbs, jax_digests, model_name, method):
    td, _, plan = _port_plan(dbs, model_name, method)
    if method == "extgraph-oj":
        assert any(not u.is_single for u in plan.units)
    comp = tpipe.PipelineCompiler(initial_capacity_clamp=8, device="cpu")
    got = text.run_plan(td.snapshot(), plan, compiler=comp)[0]
    assert comp.stats["retries"] > 0
    assert _digests(got) == jax_digests(model_name)
    # proven capacities are remembered: a replay skips the retry dance
    retries = comp.stats["retries"]
    again = text.run_plan(td.snapshot(), plan, compiler=comp)[0]
    assert comp.stats["retries"] == retries
    assert _digests(again) == jax_digests(model_name)


@pytest.mark.parametrize("model_name", ["fraud", "dblp"])
def test_forced_kernel_and_bloom_path(dbs, jax_digests, model_name):
    td, _, plan = _port_plan(dbs, model_name)
    comp = tpipe.PipelineCompiler(use_kernel=True, use_bloom=True)
    assert comp.use_kernel and comp.use_bloom
    got = text.run_plan(td.snapshot(), plan, compiler=comp)[0]
    assert _digests(got) == jax_digests(model_name)


def test_default_compiler_uses_plain_path_on_cpu(dbs):
    engine = tapi.ExtractionEngine(dbs["tpcds"][1])
    assert not engine.compiler.use_kernel and not engine.compiler.use_bloom


def test_engine_cold_warm_matches_jax(dbs):
    jd, td = dbs["dblp"]
    want = japi.ExtractionEngine(jd).extract(jdata.dblp_model())
    engine = tapi.ExtractionEngine(td)
    cold = engine.extract(tdata.dblp_model())
    warm = engine.extract(tdata.dblp_model())
    assert not cold.provenance.plan_cache_hit and cold.provenance.views_built
    assert warm.provenance.plan_cache_hit
    assert warm.provenance.views_reused == cold.provenance.views_built
    assert cold.provenance.views_built == want.provenance.views_built
    info = engine.cache_info()
    assert info["executable_hits"] > 0 and info["views"] == 1
    assert info["cache_bytes"]["views"] > 0
    assert info["device_memory"] == {}
    assert cold.graph.fingerprint() == want.graph.fingerprint()
    assert warm.graph.fingerprint() == want.graph.fingerprint()
    assert set(cold.vertices) == set(want.vertices)
    engine.clear()
    assert engine.cache_info()["plans"] == 0


def test_engine_rejects_unported_modes(dbs):
    td = dbs["tpcds"][1]
    # auto_refresh and schema discovery are ported
    # (tests/test_torch_incremental.py, tests/test_torch_discovery.py);
    # methods the planner does not know are still refused
    engine = tapi.ExtractionEngine(td, auto_refresh=True)
    assert engine.auto_refresh
    assert callable(engine.discover)
    with pytest.raises(ValueError, match="unknown method"):
        engine.extract(tdata.fraud_model("store"), method="sqlgraph")
    with pytest.raises(ValueError, match="planned methods"):
        engine.refresh(tdata.fraud_model("store"), method="ringo")


# ---------------------------------------------------------------------------
# column liveness: what each join step and each member's dedup carries
# ---------------------------------------------------------------------------

def _record_units(monkeypatch):
    """(program, unit function) of every unit function built from here on
    (the process-wide store is emptied first)."""
    built = []
    make = tpipe._make_fn

    def record(program, *args):
        fn = make(program, *args)
        built.append((program, fn))
        return fn

    monkeypatch.setattr(tpipe, "_make_fn", record)
    tpipe.clear_executable_cache()
    return built


def _view_alias(query):
    (alias,) = [r.alias for r in query.relations
                if r.table.startswith("view_")]
    return alias


def _fraud_merged(plan_mod, data_mod):
    """The fraud model's Sell and Buy as one JS-OJ unit over the largest
    shared pattern (at sf=1 the planner keeps them apart)."""
    base = plan_mod.ExtractionPlan(
        views=(), reused=(),
        units=tuple(plan_mod.PlanUnit(single=q)
                    for q in data_mod.fraud_model("store").queries()))
    cands = plan_mod._oj_candidates(base)
    best = max(cands, key=lambda c: len(c.units[-1].group.pattern.relations))
    return best.units[-1].group


def test_dblp_steps_gather_what_later_steps_read(dbs, monkeypatch):
    """Co-auth's and Auth-Edit's last steps (chain ⋈ view) gather only the
    two columns the edge projection reads; the view's unit gathers every
    column, since later queries are rewritten over it."""
    built = _record_units(monkeypatch)
    td, _, plan = _port_plan(dbs, "dblp")
    text.run_plan(td.snapshot(), plan,
                  compiler=tpipe.PipelineCompiler(device="cpu"))
    edges = {p.unit.name: (p, fn) for p, fn in built if p.kind == "edges"}
    prog, _ = edges["Co-auth"]
    assert tpipe._gather_sets(prog)[-1] == {
        "A2.a_id", f"{_view_alias(prog.unit)}.p0.a_id"}
    prog, _ = edges["Auth-Edit"]
    assert tpipe._gather_sets(prog)[-1] == {
        "E.e_id", f"{_view_alias(prog.unit)}.p0.a_id"}
    for prog, fn in edges.values():
        assert len(tpipe._gather_sets(prog)) == len(prog.capacities) == \
            len(fn.row_bytes)
        assert fn.pruned_bytes > 0
    views = [(p, fn) for p, fn in built if p.kind == "query"]
    assert views
    for prog, fn in views:
        assert set(tpipe._gather_sets(prog)) == {None}
        assert fn.pruned_bytes == 0


def test_each_fraud_member_dedups_its_own_columns(dbs, monkeypatch):
    """A JS-OJ member is cut to its dedup keys, src and dst before its
    dedup; the unit's edges still equal the JAX package's."""
    jd, td = dbs["tpcds"]
    merged = _fraud_merged(tplan, tdata)
    seen = []
    dedup = tpipe.dedup

    def record(table, keys):
        seen.append(set(table.columns))
        return dedup(table, keys)

    monkeypatch.setattr(tpipe, "dedup", record)
    got = tpipe.PipelineCompiler(device="cpu").run_merged(td, merged)
    assert len(merged.members) == 2
    assert seen == [
        {"__srow__", *(f"__brow__{b}" for b in m.branch_ids),
         m.src.qualified(), m.dst.qualified()}
        for m in merged.members]
    assert all(len(cols) == 4 for cols in seen)
    want = jpipe.PipelineCompiler().run_merged(jd,
                                               _fraud_merged(jplan, jdata))
    assert _digests(got) == {k: jops.table_digest(t) for k, t in want.items()}


@pytest.mark.parametrize("case", ["dblp", "fraud-merged"])
def test_pruned_units_give_the_unpruned_tables(dbs, monkeypatch, case):
    """With every step gathering every column (no liveness), each edge
    table is the same, column by column and slot by slot."""
    td = dbs["dblp" if case == "dblp" else "tpcds"][1]

    def run():
        tpipe.clear_executable_cache()
        comp = tpipe.PipelineCompiler(device="cpu")
        if case == "dblp":
            _, _, plan = _port_plan(dbs, "dblp")
            return text.run_plan(td.snapshot(), plan, compiler=comp)[0]
        return comp.run_merged(td, _fraud_merged(tplan, tdata))

    pruned = run()
    monkeypatch.setattr(tpipe, "_gather_sets",
                        lambda program: (None,) * len(program.capacities))
    full = run()
    tpipe.clear_executable_cache()
    assert set(pruned) == set(full)
    for label, t in full.items():
        p = pruned[label]
        assert torch.equal(p.valid, t.valid)
        assert set(p.columns) == set(t.columns)
        for name, col in t.columns.items():
            assert torch.equal(p[name], col), (label, name)


def test_post_filter_and_closing_columns_are_gathered(monkeypatch):
    """A query whose steps have a second condition (a post-filter) and a
    cycle-closing one (a self-condition): the compiled unit keeps the
    columns they read until they are read, so its edges equal the eager
    executor's bag, and the unpruned unit's tables slot by slot."""
    from repro_torch.core.executor import edge_output, execute_query
    from repro_torch.core.model import (ColumnRef, JoinCond, JoinQuery,
                                        Relation)

    rng = np.random.default_rng(5)
    n = 600

    def cols(*names):
        out = {c: rng.integers(0, 6, n).astype(np.int32) for c in names}
        out["id"] = np.arange(n, dtype=np.int32)
        out["valid"] = rng.random(n) < 0.9
        return out

    td = tdb.from_numpy_tables({"a": cols("k", "x", "w"),
                                "b": cols("k", "x", "m", "w"),
                                "c": cols("m", "u", "v", "w")},
                               device="cpu")
    query = JoinQuery(
        name="cyc",
        relations=(Relation("A", "a"), Relation("B", "b"),
                   Relation("C", "c")),
        conds=(JoinCond("A", "k", "B", "k"), JoinCond("A", "x", "B", "x"),
               JoinCond("B", "m", "C", "m"), JoinCond("C", "u", "C", "v")),
        src=ColumnRef("A", "id"), dst=ColumnRef("C", "id"))

    def run():
        tpipe.clear_executable_cache()
        return tpipe.PipelineCompiler(device="cpu").run_query_edges(td,
                                                                    query)

    got = run()
    want = edge_output(execute_query(td, query), query.src, query.dst)
    assert int(want.valid.sum()) > 0
    assert tops.table_digest(got) == tops.table_digest(want)
    monkeypatch.setattr(tpipe, "_gather_sets",
                        lambda program: (None,) * len(program.capacities))
    full = run()
    tpipe.clear_executable_cache()
    assert torch.equal(got.valid, full.valid)
    for name, col in full.columns.items():
        assert torch.equal(got[name], col), name
