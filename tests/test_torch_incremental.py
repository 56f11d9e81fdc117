"""The port's incremental layer against the JAX package, on the CPU.

The same tables (the JAX package's ``make_tpcds(sf=1)``, ``make_imdb(scale=1)``
and ``make_dblp(scale=1)``, carried to the port through
``from_numpy_tables``) and the same scripted mutations (numpy, from a seed)
go through both packages.  Compared exactly:

* after every mutation: ``Database.stats`` (incremental stats are
  approximations, and must be the *same* approximations — Algorithm 2
  plans from them), ``epoch``, the changelog, table digests and
  capacities;
* ``merge_deltas`` / ``apply_table_delta``: digests and capacities;
* ``query_delta_terms``: the versioned term queries;
* ``refresh()``: the whole ``RefreshProvenance`` of every round, and the
  edge/vertex digests against the JAX refresh and a from-scratch port
  extract over the mutated tables;
* analytics on a CSR patched by a refresh: WCC exactly, PageRank to the
  graph tests' tolerances (rtol 1e-4 on TPC-DS's item hubs, atol 1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.pipeline as jpipe
import repro.api as japi
import repro.core.database as jdbm
import repro.data as jdata
import repro.incremental as jinc
import repro.relational as jrel
from repro.relational.ops import table_digest as jdigest
import repro_torch.api as tapi
import repro_torch.core.database as tdbm
import repro_torch.data as tdata
import repro_torch.incremental as tinc
import repro_torch.relational as trel
from repro_torch.relational.ops import table_digest as tdigest

PR_RTOL_HUBS = 1e-4
PR_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_executables_cold():
    """Empty the JAX package's process-wide executable store after this
    module: its own tests count the compiles of a cold request, and may
    run next in the same worker process."""
    yield
    jpipe.clear_executable_cache()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _host_tables(db):
    return {t: {**{c: np.asarray(tab[c]) for c in tab.columns},
                "valid": np.asarray(tab.valid)}
            for t, tab in db.tables.items()}


@pytest.fixture(scope="module")
def bases():
    """{name: JAX database} of the JAX package's generators, made once."""
    return {"tpcds": jdata.make_tpcds(sf=1, seed=0),
            "dblp": jdata.make_dblp(scale=1, seed=1),
            "imdb": jdata.make_imdb(scale=1, seed=2)}


def _pair(bases, name):
    """A fresh (JAX database, port database) over the same tables (the
    tables are immutable, so every pair may share the JAX ones)."""
    jd = jdbm.Database(dict(bases[name].tables))
    td = tdbm.from_numpy_tables(_host_tables(jd), device="cpu")
    assert td.fingerprint() == jd.fingerprint()
    return jd, td


def _small_pair(**cols):
    jd = jdbm.Database({"t": jrel.Table.from_arrays(**cols)})
    td = tdbm.Database({"t": trel.Table.from_arrays(device="cpu", **cols)})
    return jd, td


def _changelog(db):
    return {n: (log.base_epoch,
                [(e.epoch, e.plus_count, e.minus_count) for e in log.entries])
            for n, log in sorted(db.changelog.items())}


def _assert_same_db(jd, td):
    assert td.epoch == jd.epoch
    assert sorted(td.tables) == sorted(jd.tables)
    for t in jd.tables:
        assert dataclasses.asdict(td.stats[t]) == \
            dataclasses.asdict(jd.stats[t]), t
        assert td.tables[t].capacity == jd.tables[t].capacity, t
        assert tdigest(td.tables[t]) == jdigest(jd.tables[t]), t
    assert td.fingerprint() == jd.fingerprint()
    assert _changelog(td) == _changelog(jd)


def _churn_tpcds(db, rng, n_ins=12, n_del=9, table="store_sales"):
    """The JAX incremental tests' churn, for either package's database."""
    n = int(_np(db.tables[table]["rid"]).max()) + 1
    db.insert_rows(
        table,
        rid=np.arange(n, n + n_ins, dtype=np.int32),
        c_sk=rng.integers(0, db.stats["customer"].rows, n_ins).astype(np.int32),
        i_sk=rng.integers(0, db.stats["item"].rows, n_ins).astype(np.int32),
        p_sk=rng.integers(0, db.stats["promotion"].rows, n_ins).astype(np.int32),
        o_sk=rng.integers(0, 4, n_ins).astype(np.int32))
    if n_del:
        live = np.flatnonzero(_np(db.tables[table].valid))
        mask = np.zeros(db.tables[table].capacity, dtype=bool)
        mask[rng.choice(live, n_del, replace=False)] = True
        db.delete_rows(table, mask)


def _both(jd, td, fn, seed):
    """Apply ``fn(db, rng)`` to both databases with equal generators."""
    fn(jd, np.random.default_rng(seed))
    fn(td, np.random.default_rng(seed))


# ---------------------------------------------------------------------------
# change capture: stats, epochs, changelog
# ---------------------------------------------------------------------------

def _ins(db, rng):
    db.insert_rows("t", rid=np.array([100, 101], np.int32),
                   k=np.array([7, 7], np.int32))


def _del_mask(db, rng):
    mask = np.zeros(db.tables["t"].capacity, dtype=bool)
    mask[[1, 3, 4]] = True
    db.delete_rows("t", mask)


def _del_idx(db, rng):
    db.delete_rows("t", np.array([0, 5]))


def _del_bag(db, rng):
    # one phantom (999) among real rows: only real matches are logged
    db.apply_delta("t", minus={"rid": np.array([2, 6, 999], np.int32),
                               "k": np.array([2, 0, 1], np.int32)})


def _del_where(db, rng):
    db.delete_where("t", "k", "==", 1)


def _del_all(db, rng):
    db.delete_rows("t", np.arange(db.tables["t"].capacity))
    db.insert_rows("t", rid=np.array([50, 51], np.int32),
                   k=np.array([9, 9], np.int32))


def _replace(db, rng):
    db.insert_rows("t", rid=np.array([10], np.int32), k=np.array([3], np.int32))
    table_cls = jrel.Table if isinstance(db, jdbm.Database) else None
    cols = dict(rid=np.arange(5, dtype=np.int32),
                k=np.array([4, 4, 1, 0, 2], np.int32))
    db.add_table("t", table_cls.from_arrays(**cols) if table_cls
                 else trel.Table.from_arrays(device="cpu", **cols))


def _prune(db, rng):
    db.insert_rows("t", rid=np.array([10], np.int32), k=np.array([3], np.int32))
    db.insert_rows("t", rid=np.array([11], np.int32), k=np.array([5], np.int32))
    assert db.prune_changelog(db.epoch - 1) >= 1
    assert not db.covers_epoch("t", 0)
    assert len(db.deltas_since("t", 0)) == 1


def _plus_and_minus(db, rng):
    db.apply_delta("t", plus={"rid": np.array([200, 201], np.int32),
                              "k": np.array([0, 8], np.int32)},
                   minus=np.array([2, 7]))


def _empty_delta(db, rng):
    db.apply_delta("t", minus={"rid": np.array([999], np.int32),
                               "k": np.array([0], np.int32)})


MUTATIONS = {"insert": _ins, "delete_mask": _del_mask,
             "delete_indices": _del_idx, "delete_bag": _del_bag,
             "delete_where": _del_where, "delete_to_empty": _del_all,
             "replace": _replace, "prune": _prune,
             "plus_and_minus": _plus_and_minus, "empty_delta": _empty_delta}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_stats_match_jax(name):
    jd, td = _small_pair(rid=np.arange(10, dtype=np.int32),
                         k=(np.arange(10, dtype=np.int32) % 3))
    _both(jd, td, MUTATIONS[name], 0)
    _assert_same_db(jd, td)
    # then an insert on top: the approximations keep folding alike
    _both(jd, td, _ins, 0)
    _assert_same_db(jd, td)
    # and an exact re-ANALYZE resets both to the same values
    assert dataclasses.asdict(td.analyze("t")) == \
        dataclasses.asdict(jd.analyze("t"))


def test_mixed_churn_stats_match_jax_every_round():
    """Twelve insert+delete rounds: NDV scaling with ``round`` stays
    integer-for-integer equal to the JAX package's."""
    rng = np.random.default_rng(0)
    jd, td = _small_pair(rid=np.arange(256, dtype=np.int32),
                         k=rng.integers(0, 32, 256).astype(np.int32))

    def round_(db, r):
        n = 16
        start = int(_np(db.tables["t"]["rid"]).max()) + 1
        db.insert_rows("t", rid=np.arange(start, start + n, dtype=np.int32),
                       k=r.integers(0, 32, n).astype(np.int32))
        live = np.flatnonzero(_np(db.tables["t"].valid))
        mask = np.zeros(db.tables["t"].capacity, dtype=bool)
        mask[r.choice(live, n, replace=False)] = True
        db.delete_rows("t", mask)

    for i in range(12):
        _both(jd, td, round_, 100 + i)
        _assert_same_db(jd, td)


def test_mutations_reject_bad_input_as_jax():
    _, td = _small_pair(rid=np.arange(6, dtype=np.int32))
    with pytest.raises(ValueError, match="bool mask or integer"):
        td.delete_rows("t", np.array([0.5]))
    with pytest.raises(ValueError, match="delta columns"):
        td.insert_rows("t", rid=np.array([1], np.int32),
                       x=np.array([1], np.int32))
    with pytest.raises(ValueError, match="delete mask shape"):
        td.delete_rows("t", np.ones(3, dtype=bool))
    with pytest.raises(ValueError, match="neither"):
        td.apply_delta("t")
    assert td.epoch == 0


def test_tpcds_churn_and_snapshot_isolation_match_jax(bases):
    jd, td = _pair(bases, "tpcds")
    _both(jd, td, _churn_tpcds, 1)
    js, ts = jd.snapshot(), td.snapshot()
    fp = ts.fingerprint()
    _both(jd, td, _churn_tpcds, 2)
    _both(jd, td, lambda d, r: d.delete_where("customer", "c_id", "<", 5), 3)
    _assert_same_db(jd, td)
    # the snapshots did not move, and equal each other
    assert ts.fingerprint() == fp
    _assert_same_db(js, ts)
    # snapshot mutations never reach the parent
    epoch = td.epoch
    ts.delete_where("item", "i_id", "<", 3)
    assert td.epoch == epoch and "item" not in td.changelog


# ---------------------------------------------------------------------------
# merged deltas, the host fold, delta terms
# ---------------------------------------------------------------------------

def _delta_entries(rel, table_kw, seed):
    rng = np.random.default_rng(seed)
    out = []
    for epoch in range(1, 5):
        sides = {}
        for side in ("plus", "minus"):
            n = int(rng.integers(0, 6))
            sides[side] = rel.Table.from_arrays(
                **table_kw, a=rng.integers(0, 5, n).astype(np.int32),
                b=rng.integers(0, 3, n).astype(np.int32)) if n else None
        out.append((epoch, sides))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_deltas_and_fold_match_jax(seed):
    def entries(inc, rel, kw):
        return [inc.TableDelta(
            epoch=e, plus=s["plus"], minus=s["minus"],
            plus_count=0 if s["plus"] is None else s["plus"].capacity,
            minus_count=0 if s["minus"] is None else s["minus"].capacity)
            for e, s in _delta_entries(rel, kw, seed)]

    jm = jinc.merge_deltas(entries(jinc, jrel, {}))
    tm = tinc.merge_deltas(entries(tinc, trel, {"device": "cpu"}))
    assert (tm.plus_count, tm.minus_count) == (jm.plus_count, jm.minus_count)
    for side in ("plus", "minus"):
        jt, tt = getattr(jm, side), getattr(tm, side)
        assert (jt is None) == (tt is None)
        if jt is not None:
            assert tt.capacity == jt.capacity
            assert tdigest(tt) == jdigest(jt)
    rng = np.random.default_rng(seed + 10)
    base = dict(a=rng.integers(0, 5, 20).astype(np.int32),
                b=rng.integers(0, 3, 20).astype(np.int32))
    jt = jinc.apply_table_delta(jrel.Table.from_arrays(**base),
                                [jm.plus] if jm.plus else [],
                                [jm.minus] if jm.minus else [])
    tt = tinc.apply_table_delta(trel.Table.from_arrays(device="cpu", **base),
                                [tm.plus] if tm.plus else [],
                                [tm.minus] if tm.minus else [])
    assert tt.capacity == jt.capacity
    assert tdigest(tt) == jdigest(jt)


def test_fold_annihilates_insert_then_delete_as_jax():
    kw = dict(src=np.array([1, 2], np.int32), dst=np.array([5, 6], np.int32))
    plus = dict(src=np.array([3], np.int32), dst=np.array([7], np.int32))
    minus = dict(src=np.array([3, 1], np.int32), dst=np.array([7, 5], np.int32))
    jt = jinc.apply_table_delta(jrel.Table.from_arrays(**kw),
                                [jrel.Table.from_arrays(**plus)],
                                [jrel.Table.from_arrays(**minus)])
    tt = tinc.apply_table_delta(
        trel.Table.from_arrays(device="cpu", **kw),
        [trel.Table.from_arrays(device="cpu", **plus)],
        [trel.Table.from_arrays(device="cpu", **minus)])
    assert tt.capacity == jt.capacity == 8
    assert sorted(tt.to_rowset(["src", "dst"])) == [(2, 6, 0)]
    assert tdigest(tt) == jdigest(jt)


def _term_key(term):
    q = term.query
    return (q.name, tuple((r.alias, r.table, repr(r.filters))
                          for r in q.relations),
            repr(q.conds), repr(q.src), repr(q.dst),
            term.delta_table, term.delta_alias, term.sign)


@pytest.mark.parametrize("model_name", ["copur", "fraud", "recommendation",
                                        "dblp", "imdb"])
def test_query_delta_terms_match_jax(model_name):
    def queries(data):
        if model_name == "copur":
            return [data.tpcds.copur_query("store")]
        mk = {"fraud": lambda: data.fraud_model("store"),
              "recommendation": lambda: data.recommendation_model("store"),
              "dblp": data.dblp_model, "imdb": data.imdb_model}[model_name]
        return mk().queries()

    for jq, tq in zip(queries(jdata), queries(tdata)):
        tables = sorted({r.table for r in jq.relations})
        for k in range(1, len(tables) + 1):
            changed = set(tables[:k])
            jt = [_term_key(t) for t in
                  jinc.query_delta_terms(jq, changed)]
            tt = [_term_key(t) for t in
                  tinc.query_delta_terms(tq, changed)]
            assert tt == jt
            assert tt, changed


# ---------------------------------------------------------------------------
# refresh parity over scripted churn (the acceptance contract)
# ---------------------------------------------------------------------------

def _graph_digests(graph, digest):
    return ({k: digest(v) for k, v in graph.vertices.items()},
            {k: digest(v) for k, v in graph.edges.items()})


def _oracle(td, model, method="extgraph"):
    """From-scratch port extraction over the current table contents."""
    return tapi.ExtractionEngine(tdbm.Database(dict(td.tables))).extract(
        model, method=method)


def _scripted(bases, name, model_of, rounds, **engine_kw):
    """Cold extract, then every round on both packages; per round the
    provenance and digests must agree.  Returns both engines, the
    databases, and the paths taken."""
    jd, td = _pair(bases, name)
    jm, tm = model_of(jdata), model_of(tdata)
    je = japi.ExtractionEngine(jd, auto_refresh=True, **engine_kw)
    te = tapi.ExtractionEngine(td, auto_refresh=True, **engine_kw)
    jr, tr = je.extract(jm), te.extract(tm)
    assert tr.refresh.path == jr.refresh.path == "cold"
    assert tr.graph.fingerprint() == jr.graph.fingerprint()
    paths = []
    for i, mutate in enumerate(rounds):
        _both(jd, td, mutate, 1000 + i)
        _assert_same_db(jd, td)
        jr, tr = je.extract(jm), te.extract(tm)
        assert dataclasses.asdict(tr.refresh) == \
            dataclasses.asdict(jr.refresh), i
        want = _graph_digests(jr.graph, jdigest)
        assert _graph_digests(tr.graph, tdigest) == want, i
        assert _graph_digests(_oracle(td, tm).graph, tdigest) == want, i
        paths.append(tr.refresh.path)
    return (je, te), (jd, td), paths


def _new_items(db, rng):
    db.insert_rows("item",
                   rid=np.arange(10_000, 10_003, dtype=np.int32),
                   i_id=np.arange(10_000, 10_003, dtype=np.int32),
                   i_price=np.array([1, 2, 3], np.int32))


def test_refresh_parity_tpcds_fraud(bases):
    (_, te), _, paths = _scripted(
        bases, "tpcds", lambda d: d.fraud_model("store"), [
            lambda d, r: _churn_tpcds(d, r, n_ins=10, n_del=0),  # inserts
            lambda d, r: _churn_tpcds(d, r, n_ins=0, n_del=8),   # deletes
            lambda d, r: _churn_tpcds(d, r, n_ins=10, n_del=8),  # mixed
            _new_items,                       # the vertex set changes
        ])
    assert paths == ["delta"] * 4
    assert te.cache_info()["results"] == 1


def test_refresh_parity_imdb(bases):
    def churn_directs(d, rng):
        n = int(_np(d.tables["directs"]["rid"]).max()) + 1
        d.insert_rows(
            "directs",
            rid=np.arange(n, n + 15, dtype=np.int32),
            per_sk=rng.integers(0, d.stats["person"].rows, 15).astype(np.int32),
            m_sk=rng.integers(0, d.stats["movie"].rows, 15).astype(np.int32))

    def delete_acts(d, rng):
        live = np.flatnonzero(_np(d.tables["acts"].valid))
        mask = np.zeros(d.tables["acts"].capacity, dtype=bool)
        mask[rng.choice(live, 30, replace=False)] = True
        d.delete_rows("acts", mask)

    _, _, paths = _scripted(bases, "imdb", lambda d: d.imdb_model(),
                            [churn_directs, delete_acts])
    assert paths == ["delta", "delta"]


def test_refresh_parity_dblp_through_maintained_views(bases):
    def churn_wrote(d, rng):
        n = int(_np(d.tables["wrote"]["rid"]).max()) + 1
        d.insert_rows(
            "wrote",
            rid=np.arange(n, n + 25, dtype=np.int32),
            a_sk=rng.integers(0, d.stats["author"].rows, 25).astype(np.int32),
            p_sk=rng.integers(0, d.stats["paper"].rows, 25).astype(np.int32))
        live = np.flatnonzero(_np(d.tables["wrote"].valid))
        mask = np.zeros(d.tables["wrote"].capacity, dtype=bool)
        mask[rng.choice(live, 20, replace=False)] = True
        d.delete_rows("wrote", mask)

    (je, te), (_, td), paths = _scripted(
        bases, "dblp", lambda d: d.dblp_model(), [churn_wrote])
    assert paths == ["delta"]
    # the view was maintained in place, equal to the JAX package's and to
    # a fresh materialization
    from repro_torch.core.executor import execute_query
    from repro_torch.core.jsmv import ViewDef
    assert len(te._views) == len(je._views) == 1
    for (sig, cv), (_, jcv) in zip(te._views.items(), je._views.items()):
        assert cv.name == jcv.name
        fresh = execute_query(tdbm.Database(dict(td.tables)),
                              ViewDef(cv.name, cv.pattern).as_query())
        assert tdigest(cv.table) == tdigest(fresh) == jdigest(jcv.table)
        assert dataclasses.asdict(cv.stats) == dataclasses.asdict(jcv.stats)
    # a request that reads the maintained view (fresh plan, cached view
    # adopted as a free JS-MV rewrite) is still exact
    r2 = te.extract(tdata.dblp_model(), method="extgraph-mv",
                    auto_refresh=False)
    assert _graph_digests(r2.graph, tdigest) == _graph_digests(
        _oracle(td, tdata.dblp_model(), method="extgraph-mv").graph, tdigest)


def _paths_sequence(engine, db, model):
    """The JAX test's noop / threshold / fallback script, for either
    package; returns the provenance of every step (and checks parity
    with a from-scratch extract in the caller)."""
    out = [engine.refresh(model).refresh, engine.refresh(model).refresh]
    rng = np.random.default_rng(6)
    _churn_tpcds(db, rng, n_ins=5, n_del=0)
    out.append(engine.refresh(model).refresh)
    hit = engine.extract(model).provenance.plan_cache_hit
    plans = engine.cache_info()["plans"]
    _churn_tpcds(db, rng, n_ins=600, n_del=0)
    full = engine.refresh(model)
    out.append(full.refresh)
    return out, hit, plans, full


def test_refresh_paths_noop_threshold_and_fallbacks_match_jax(bases):
    jd, td = _pair(bases, "tpcds")
    je = japi.ExtractionEngine(jd, refresh_threshold=0.05)
    te = tapi.ExtractionEngine(td, refresh_threshold=0.05)
    jout, jhit, jplans, jfull = _paths_sequence(
        je, jd, jdata.fraud_model("store"))
    tout, thit, tplans, tfull = _paths_sequence(
        te, td, tdata.fraud_model("store"))
    assert [r.path for r in tout] == ["cold", "noop", "delta", "full"]
    assert [dataclasses.asdict(r) for r in tout] == \
        [dataclasses.asdict(r) for r in jout]
    assert 0.0 < tout[2].churn <= 0.05 < tout[3].churn
    # the delta path re-keys the plan: a plain extract right after hits
    assert thit and jhit and tplans == jplans == 1
    want = _graph_digests(jfull.graph, jdigest)
    assert _graph_digests(tfull.graph, tdigest) == want
    assert _graph_digests(_oracle(td, tdata.fraud_model("store")).graph,
                          tdigest) == want

    # wholesale replacement breaks the changelog: full path again
    fresh = jdata.make_tpcds(sf=1, seed=9).table("store_sales")
    jd.add_table("store_sales", fresh)
    td.add_table("store_sales", trel.Table.from_arrays(
        device="cpu", capacity=fresh.capacity,
        **{c: np.asarray(v)[np.asarray(fresh.valid)]
           for c, v in fresh.columns.items()}))
    _assert_same_db(jd, td)
    jr = je.refresh(jdata.fraud_model("store"))
    tr = te.refresh(tdata.fraud_model("store"))
    assert tr.refresh.path == "full"
    assert dataclasses.asdict(tr.refresh) == dataclasses.asdict(jr.refresh)
    assert _graph_digests(tr.graph, tdigest) == \
        _graph_digests(jr.graph, jdigest)
    with pytest.raises(ValueError):
        te.refresh(tdata.fraud_model("store"), method="ringo")


def test_unrelated_churn_keeps_plan_and_views(bases):
    jd, td = _pair(bases, "tpcds")
    engine = tapi.ExtractionEngine(td)
    model = tdata.recommendation_model("store")
    first = engine.extract(model)
    assert first.provenance.views_built
    n_views = engine.cache_info()["views"]
    _churn_tpcds(td, np.random.default_rng(7), table="web_sales")
    after = engine.extract(model)
    assert after.provenance.plan_cache_hit
    assert set(after.provenance.views_reused) == \
        set(first.provenance.views_built)
    assert not after.provenance.views_built
    assert engine.cache_info()["views"] == n_views
    # related churn still invalidates; the result equals the JAX package's
    _both(jd, td, lambda d, r: _churn_tpcds(d, r, n_ins=5, n_del=0), 8)
    related = engine.extract(model)
    assert not related.provenance.plan_cache_hit
    want = japi.ExtractionEngine(jd).extract(
        jdata.recommendation_model("store"))
    assert related.graph.fingerprint() == want.graph.fingerprint()


def test_auto_refresh_on_extract_and_analyze(bases):
    jd, td = _pair(bases, "tpcds")
    model = tdata.fraud_model("store")
    # engine-level: unrelated churn is a noop
    engine = tapi.ExtractionEngine(td, auto_refresh=True)
    assert engine.auto_refresh and engine.refresh_threshold == 0.1
    assert engine.extract(model).refresh.path == "cold"
    _churn_tpcds(td, np.random.default_rng(8), table="catalog_sales")
    assert engine.extract(model).refresh.path == "noop"
    # per-call: a plain engine maintains only when asked
    plain = tapi.ExtractionEngine(td)
    assert plain.extract(model).refresh is None
    _churn_tpcds(td, np.random.default_rng(9), n_ins=4, n_del=2)
    r = plain.extract(model, auto_refresh=True)
    assert r.refresh.path == "delta"
    a = plain.analyze(model, algorithm="degree_stats", auto_refresh=True)
    assert a.extraction.refresh.path == "noop"
    # new customers no sale references: edges stay, vertices move
    td.insert_rows("customer", rid=np.array([90_000], np.int32),
                   c_id=np.array([90_000], np.int32),
                   c_prop=np.array([1], np.int32))
    r = engine.extract(model)
    assert r.refresh.path == "delta"
    assert r.graph.fingerprint() == _oracle(td, model).graph.fingerprint()
    assert engine.cache_info()["requests"]["refreshes"] == 3


def test_view_staleness_uses_changelog_not_fingerprint(bases):
    _, td = _pair(bases, "tpcds")
    engine = tapi.ExtractionEngine(td, auto_refresh=True)
    model = tdata.recommendation_model("store")
    assert engine.extract(model).provenance.views_built
    _churn_tpcds(td, np.random.default_rng(11), n_ins=6, n_del=6)
    # the stats-fingerprint collision: only the changelog can tell
    for sig, cv in list(engine._views.items()):
        cv = dataclasses.replace(cv, base_fingerprints={
            t: engine._table_fingerprint(t) for t in cv.base_fingerprints})
        engine._views.put(sig, cv)
        assert engine._view_bases_mutated(cv)
    r = engine.extract(model)
    assert r.refresh.path == "delta" and r.refresh.views_maintained
    assert r.graph.fingerprint() == _oracle(td, model).graph.fingerprint()


def test_fork_shares_entries_and_advances_privately(bases):
    _, td = _pair(bases, "tpcds")
    model = tdata.fraud_model("store")
    engine = tapi.ExtractionEngine(td, auto_refresh=True)
    served = engine.extract(model).graph.fingerprint()
    _churn_tpcds(td, np.random.default_rng(12), n_ins=5, n_del=3)
    fork = engine.fork(td.snapshot())
    assert fork.compiler is engine.compiler
    assert fork.cache_info()["results"] == 1
    r = fork.extract(model)
    assert r.refresh.path == "delta"
    assert r.graph.fingerprint() == _oracle(td, model).graph.fingerprint()
    # the parent's entry was replaced in the fork, not mutated
    key = next(iter(engine._results.keys()))
    assert engine._results.get(key).graph.fingerprint() == served


# ---------------------------------------------------------------------------
# the patched CSR
# ---------------------------------------------------------------------------

def test_refresh_patches_cached_csr_and_analytics_match_jax(bases):
    jd, td = _pair(bases, "tpcds")
    je = japi.ExtractionEngine(jd, auto_refresh=True)
    te = tapi.ExtractionEngine(td, auto_refresh=True)
    jm, tm = jdata.fraud_model("store"), tdata.fraud_model("store")
    cold = te.analyze(tm, algorithm="pagerank", label="Buy", iters=8)
    je.analyze(jm, algorithm="pagerank", label="Buy", iters=8)
    _both(jd, td, lambda d, r: _churn_tpcds(d, r, n_ins=8, n_del=6), 9)

    warm = te.analyze(tm, algorithm="pagerank", label="Buy", iters=8)
    jwarm = je.analyze(jm, algorithm="pagerank", label="Buy", iters=8)
    assert warm.extraction.refresh.path == "delta"
    assert warm.extraction.refresh.csr_patched
    assert dataclasses.asdict(warm.extraction.refresh) == \
        dataclasses.asdict(jwarm.extraction.refresh)
    assert warm.provenance.csr_cache_hit      # the patched CSR served it
    assert warm.provenance.csr_key != cold.provenance.csr_key
    assert warm.provenance.csr_key == jwarm.provenance.csr_key
    assert "Buy" in warm.csr.dirty
    np.testing.assert_allclose(_np(warm.values), np.asarray(jwarm.values),
                               rtol=PR_RTOL_HUBS, atol=PR_ATOL)
    oracle = tapi.ExtractionEngine(tdbm.Database(dict(td.tables))).analyze(
        tm, algorithm="pagerank", label="Buy", iters=8)
    np.testing.assert_allclose(_np(warm.values), _np(oracle.values),
                               rtol=PR_RTOL_HUBS, atol=PR_ATOL)
    wcc = te.analyze(tm, algorithm="wcc")
    jwcc = je.analyze(jm, algorithm="wcc")
    assert wcc.provenance.csr_cache_hit
    assert np.array_equal(_np(wcc.values), np.asarray(jwcc.values))


def test_refresh_patch_compacts_a_label_like_jax(bases):
    """Churn past the CSR's compaction threshold (more tombstones than
    live edges on ``Buy``): the label is re-sorted, and the patched CSR
    equals the JAX package's array for array."""
    jd, td = _pair(bases, "tpcds")
    je = japi.ExtractionEngine(jd, auto_refresh=True, refresh_threshold=1.0)
    te = tapi.ExtractionEngine(td, auto_refresh=True, refresh_threshold=1.0)
    jm, tm = jdata.fraud_model("store"), tdata.fraud_model("store")
    te.analyze(tm, algorithm="degree_stats")
    je.analyze(jm, algorithm="degree_stats")
    n = td.stats["store_sales"].rows
    _both(jd, td, lambda d, r: _churn_tpcds(d, r, n_ins=0,
                                            n_del=int(n * 0.6)), 10)
    warm = te.analyze(tm, algorithm="degree_stats")
    jwarm = je.analyze(jm, algorithm="degree_stats")
    assert warm.extraction.refresh.path == "delta"
    assert warm.extraction.refresh.csr_patched
    assert "Buy" not in warm.csr.dirty and "Buy" not in jwarm.csr.dirty
    for field in ("offsets", "targets", "sources"):
        for label in ("Buy", "Sell"):
            assert np.array_equal(_np(getattr(warm.csr, field)[label]),
                                  np.asarray(getattr(jwarm.csr, field)[label]))
    for k in ("out_degree", "in_degree"):
        assert np.array_equal(_np(warm.values[k]), np.asarray(jwarm.values[k]))


def test_patched_csr_nets_edges_inserted_and_deleted_in_one_window(bases):
    """Rows inserted and deleted between two refreshes: their edges are in
    both signed sides of the delta.  The patched CSR must hold the same
    edge bag as a fresh build.  (The JAX package's patch tombstones first
    and appends after, so it keeps such an edge when no older copy of it
    exists; the port nets the two sides first — ROADMAP.md §3.)"""
    import collections

    _, td = _pair(bases, "tpcds")
    model = tdata.fraud_model("store")
    engine = tapi.ExtractionEngine(td, auto_refresh=True)
    engine.analyze(model, algorithm="degree_stats")
    rng = np.random.default_rng(21)
    before = td.tables["store_sales"].capacity
    _churn_tpcds(td, rng, n_ins=12, n_del=0)
    new_slots = np.flatnonzero(_np(td.tables["store_sales"]["rid"])
                               >= before)[:6]
    old_slots = rng.choice(np.flatnonzero(
        _np(td.tables["store_sales"]["rid"]) < before), 3, replace=False)
    td.delete_rows("store_sales", np.concatenate([new_slots, old_slots]))
    warm = engine.analyze(model, algorithm="degree_stats")
    assert warm.extraction.refresh.path == "delta"
    assert warm.extraction.refresh.csr_patched
    fresh = tapi.ExtractionEngine(tdbm.Database(dict(td.tables))).analyze(
        model, algorithm="degree_stats")

    def bag(csr, label):
        s, d, v = [_np(x) for x in csr.coo(label)]
        return collections.Counter(zip(s[v].tolist(), d[v].tolist()))

    for label in ("Buy", "Sell"):
        assert bag(warm.csr, label) == bag(fresh.csr, label), label
        assert warm.csr.edge_counts[label] == fresh.csr.edge_counts[label]
    for k in ("out_degree", "in_degree"):
        assert np.array_equal(_np(warm.values[k]), _np(fresh.values[k]))


@pytest.mark.parametrize("value", [2**40, 2**32 + 2, -2**40])
@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
def test_delete_where_compares_python_ints_exactly(op, value):
    """``delete_where`` with a Python int outside int32 compares exactly,
    as the reference's host numpy does: ``x > 2**40`` deletes nothing and
    ``x < 2**32 + 2`` deletes every row of ``[1, 2, 3, -5]`` (torch used
    to wrap the int to int32 and delete other rows).  Same deleted rows,
    delta counts and epochs as JAX's ``Database``."""
    col = np.array([1, 2, 3, -5], np.int32)
    rid = np.arange(4, dtype=np.int32)
    jd = jdbm.Database({"t": jrel.Table.from_arrays(rid=rid, x=col)})
    td = tdbm.Database({"t": trel.Table.from_arrays(device="cpu", rid=rid,
                                                    x=col)})
    jentry = jd.delete_where("t", "x", op, value)
    tentry = td.delete_where("t", "x", op, value)
    assert (tentry.plus_count, tentry.minus_count, td.epoch) == \
        (jentry.plus_count, jentry.minus_count, jd.epoch)
    np.testing.assert_array_equal(td.tables["t"].valid.numpy(),
                                  np.asarray(jd.tables["t"].valid))
    want = {"==": 0, "!=": 4, "<": 4, "<=": 4, ">": 0, ">=": 0}[op]
    if value < 0:
        want = {"==": 0, "!=": 4, "<": 0, "<=": 0, ">": 4, ">=": 4}[op]
    assert tentry.minus_count == want
