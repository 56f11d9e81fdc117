"""The port's EXPLAIN / EXPLAIN ANALYZE against the JAX package, on the CPU.

Mirrors the JAX package's EXPLAIN tests on the port (tpcds / dblp / imdb at
sf=1 / scale=1): ``explain`` runs nothing and warms the plan cache;
``explain_analyze`` reports actual rows for every step of every unit and
adds **zero host syncs** — counted both as ``pipeline.sync`` spans (the
JAX test's count) and by wrapping every tensor-to-host point of the port
(``Tensor.cpu`` / ``numpy`` / ``item`` / ``tolist`` / ``__bool__`` /
``__int__`` / ``__float__`` and ``torch.cuda.synchronize``).

Parity: the port's ``PlanReport.to_json()`` equals the JAX package's on
the same tables and model — plan structure, join orders, capacities and
their source, costs, estimated and actual rows — except ``executable``,
whose meaning is the port's own (whether the built unit function is
cached; the port compiles nothing) and the wall-clock ``timings_s``.
"""
import json
import math

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.pipeline as jpipe
import repro.data as jdata
from repro_torch import obs
from repro_torch.api import ExtractionEngine
from repro_torch.api.engine import _LRUCache
from repro_torch.core.database import from_numpy_tables
from repro_torch.core.pipeline import PipelineCompiler
import repro_torch.data as tdata

DATASETS = {
    "tpcds": (lambda d: d.make_tpcds(sf=1), lambda d: d.fraud_model("store")),
    "dblp": (lambda d: d.make_dblp(scale=1), lambda d: d.dblp_model()),
    "imdb": (lambda d: d.make_imdb(scale=1), lambda d: d.imdb_model()),
}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_executables_cold():
    """Empty the JAX package's process-wide executable store after this
    module: its own tests count the compiles of a cold request, and may
    run next in the same worker process."""
    yield
    jpipe.clear_executable_cache()


@pytest.fixture(scope="module", params=sorted(DATASETS))
def dataset(request):
    """(name, JAX db, port db, JAX model, port model) on the same tables."""
    make, model = DATASETS[request.param]
    jd = make(jdata)
    host = {t: {**{c: np.asarray(tab[c]) for c in tab.columns},
                "valid": np.asarray(tab.valid)}
            for t, tab in jd.tables.items()}
    td = from_numpy_tables(host, device="cpu")
    return request.param, jd, td, model(jdata), model(tdata)


def _units(report):
    return list(report.views) + list(report.units)


def _engine(td):
    return ExtractionEngine(td.snapshot(),
                            compiler=PipelineCompiler(device="cpu"))


# -- EXPLAIN: plan visibility without execution ------------------------------

def test_explain_runs_nothing_and_reports_the_plan(dataset):
    name, _, td, _, model = dataset
    engine = _engine(td)
    report = engine.explain(model)
    assert engine.cache_info()["requests"].get("full_extracts", 0) == 0
    assert engine.compiler.stats["compiled"] == 0
    assert not report.analyzed
    assert report.cost_plan <= report.cost_baseline
    assert math.isfinite(report.sharing_speedup)
    units = _units(report)
    assert units, name
    for u in units:
        assert u.kind in ("view", "edges", "merged")
        assert math.isfinite(u.est_cost) and u.est_cost >= 0
        assert u.executable in ("cached", "uncompiled", "unknown", "eager")
        assert u.capacity_source in ("programs", "memo", "estimated")
        assert len(u.steps) == len(u.capacities)
        for s in u.steps:
            assert s.capacity > 0 and s.capacity & (s.capacity - 1) == 0
            assert math.isfinite(s.est_rows) and s.est_rows >= 0
            assert s.actual_rows is None and s.utilization is None
        if u.kind == "merged":
            assert len(u.members) > 1


def test_explain_text_and_json_renderings(dataset):
    _, _, td, _, model = dataset
    report = _engine(td).explain(model)
    text = report.render_text()
    assert "PLAN" in text and "cost" in text
    for u in _units(report):
        assert u.name in text
    js = json.loads(json.dumps(report.to_json()))
    assert js["model"] == report.model
    assert len(js["units"]) == len(report.units)


def test_explain_warms_the_plan_cache_for_the_extract(dataset):
    _, _, td, _, model = dataset
    engine = _engine(td)
    assert not engine.explain(model).plan_cache_hit
    before = engine.cache_info()["caches"]["plans"]["hits"]
    engine.extract(model)
    assert engine.cache_info()["caches"]["plans"]["hits"] == before + 1
    assert engine.explain(model).plan_cache_hit


def test_explain_eager_engine_reports_estimates(dataset):
    _, _, td, _, model = dataset
    report = ExtractionEngine(td.snapshot(), compiled=False).explain(model)
    for u in _units(report):
        assert u.executable == "eager" and u.capacity_source == "estimated"
    with pytest.raises(ValueError, match="planned methods"):
        ExtractionEngine(td).explain(model, method="ringo")


# -- EXPLAIN ANALYZE: actuals for every plan unit, zero added syncs ----------

def test_explain_analyze_reports_actuals_for_every_unit(dataset):
    name, _, td, _, model = dataset
    report = _engine(td).explain_analyze(model)
    assert report.analyzed
    assert set(report.timings_s) == {"plan", "extract"}
    steps_seen = 0
    for u in _units(report):
        assert u.executable == "cached", (name, u.name)
        assert u.capacity_source in ("programs", "memo"), (name, u.name)
        for s in u.steps:
            steps_seen += 1
            assert s.actual_rows is not None, (name, u.name, s.label)
            assert 0 <= s.actual_rows <= s.capacity
            assert 0.0 <= s.utilization <= 1.0
            assert math.isfinite(s.estimate_ratio) and s.estimate_ratio > 0
    assert steps_seen, name


def _sync_spans():
    spans = obs.TRACER.get(obs.TRACER.trace_ids()[-1])
    return sum(1 for s in spans if s["name"] == "pipeline.sync")


_HOST_POINTS = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
                "__float__")


@pytest.fixture
def host_points(monkeypatch):
    """Counts every call of the port's tensor-to-host points."""
    counts = {"n": 0}

    def wrap(fn):
        def counted(*args, **kwargs):
            counts["n"] += 1
            return fn(*args, **kwargs)
        return counted

    for name in _HOST_POINTS:
        monkeypatch.setattr(torch.Tensor, name, wrap(getattr(torch.Tensor,
                                                             name)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        wrap(torch.cuda.synchronize))
    return counts


def test_explain_analyze_adds_zero_host_syncs(dataset, host_points):
    name, _, td, _, model = dataset
    plain = _engine(td)
    before = host_points["n"]
    plain.extract(model)
    plain_points = host_points["n"] - before
    plain_syncs = _sync_spans()
    analyzed = _engine(td)
    before = host_points["n"]
    analyzed.explain_analyze(model)
    assert plain_syncs > 0 and plain_points > 0, name
    # identical cold pipelines: the report rides the overflow check's
    # existing host syncs, adding none
    assert _sync_spans() == plain_syncs, name
    assert host_points["n"] - before == plain_points, name
    # and plain EXPLAIN touches no tensor at all
    before = host_points["n"]
    _engine(td).explain(model)
    assert host_points["n"] == before, name


# -- parity with the JAX package ---------------------------------------------

def _comparable(report):
    js = report.to_json()
    js.pop("timings_s")
    for u in js["views"] + js["units"]:
        u.pop("executable")
    return js


@pytest.mark.parametrize("analyze", [False, True])
def test_plan_report_json_matches_jax(dataset, analyze):
    name, jd, td, jmodel, tmodel = dataset
    jeng = japi.ExtractionEngine(jd.snapshot(),
                                 compiler=jpipe.PipelineCompiler())
    teng = _engine(td)
    jr = jeng.explain(jmodel, analyze=analyze)
    tr = teng.explain(tmodel, analyze=analyze)
    assert _comparable(tr) == _comparable(jr), name
    # a second EXPLAIN (plan cache hit, programs proven by the run)
    assert _comparable(teng.explain(tmodel)) == \
        _comparable(jeng.explain(jmodel)), name
    if analyze:
        for tu, ju in zip(_units(tr), _units(jr)):
            assert tu.executable == ju.executable == "cached"


# -- device-memory accounting ------------------------------------------------

def test_table_byte_accounting_is_exact(dataset):
    _, _, td, _, _ = dataset
    table = td.tables[sorted(td.tables)[0]]
    want = sum(c.numel() * c.element_size() for c in table.columns.values())
    want += table.valid.numel() * table.valid.element_size()
    assert obs.table_nbytes(table) == want
    assert obs.entry_nbytes(table) == want
    assert obs.entry_nbytes(object()) == 0


def test_cache_bytes_surface_after_extract(dataset):
    _, _, td, _, model = dataset
    engine = _engine(td)
    engine.extract(model)
    info = engine.cache_info()
    assert set(info["cache_bytes"]) == {"plans", "views", "csrs", "results"}
    assert info["cache_bytes"]["results"] > 0
    assert obs.REGISTRY.value("engine_cache_bytes", cache="results") == \
        info["cache_bytes"]["results"]


def test_lru_byte_budget_eviction_and_seed():
    cache = _LRUCache(10, name="unit-test", sizer=len, max_bytes=100)
    cache.put("a", b"x" * 60)
    cache.put("b", b"y" * 60)          # 120 > 100: evicts "a"
    assert cache.get("a") is None and cache.get("b") is not None
    assert cache.bytes == 60
    info = cache.info()
    assert info["bytes"] == 60 and info["max_bytes"] == 100
    assert info["byte_evictions"] == 1
    cache.put("huge", b"z" * 500)
    assert cache.get("huge") is not None and len(cache) == 1
    # a fork's seed shares the entries and keeps its own books
    clone = _LRUCache(10, name="unit-test-fork", sizer=len)
    clone.seed(cache)
    assert clone.get("huge") is not None and clone.bytes == 500
    assert clone.hits == 1 and cache.hits == 2
    cache.pop("huge")
    assert cache.bytes == 0 and clone.bytes == 500


def test_engine_byte_budget_bounds_result_cache(dataset):
    _, _, td, _, model = dataset
    engine = ExtractionEngine(td.snapshot(),
                              compiler=PipelineCompiler(device="cpu"),
                              cache_byte_budgets={"results": 1})
    engine.extract(model)
    info = engine.cache_info()
    assert info["caches"]["results"]["size"] == 1
    assert info["caches"]["results"]["max_bytes"] == 1
