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
    # auto_refresh is ported (tests/test_torch_incremental.py); schema
    # discovery is not, and the engine has no stand-in for it
    engine = tapi.ExtractionEngine(td, auto_refresh=True)
    assert engine.auto_refresh
    assert not hasattr(engine, "discover")
    with pytest.raises(ValueError, match="unknown method"):
        engine.extract(tdata.fraud_model("store"), method="sqlgraph")
    with pytest.raises(ValueError, match="planned methods"):
        engine.refresh(tdata.fraud_model("store"), method="ringo")
