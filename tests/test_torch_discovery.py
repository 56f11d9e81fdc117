"""The port's schema discovery, alone and against the JAX package, on the CPU.

Every test of ``tests/test_discovery.py`` has a counterpart here, and the
two packages take the same numpy inputs and are held to one result:

* the KMV sketch bit for bit (``0xFFFFFFFF`` padding when ``cap < k`` or
  fewer than k distinct hashes, all-NULL columns, negative keys);
* every profile field for field;
* every candidate's pair, sample, ``matched`` and confidence, on the
  compiled path and the eager one;
* on anonymized tpcds sf=10, dblp and imdb: the profiles, candidates,
  accepted FKs, edge candidates (spec and signature) and the quality
  numbers, which also meet the JAX tests' thresholds;
* the engine's two caches and a fork's inheritance, the spec round trip,
  and the service's and the HTTP front end's discover payloads.

Confidences are Python floats computed by the same arithmetic from equal
integers, so they are compared exactly.
"""
import dataclasses
import json
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.database as jdbm
import repro.core.pipeline as jpipe
import repro.discovery as jdisc
import repro.discovery.profile as jprof
import repro.relational as jrel
from repro_torch.api import (
    ExtractionEngine,
    GraphModelBuilder,
    join_query,
    model_from_json,
    model_from_spec,
    model_to_spec,
)
from repro_torch.core.database import Database
from repro_torch.core.pipeline import PipelineCompiler, clear_executable_cache
from repro_torch.discovery import (
    anonymize_columns,
    canonicalize_pairs,
    column_equivalence,
    discover,
    edge_recovery,
    fk_pairs,
    infer_join_keys,
    model_fk_pairs,
    precision_recall,
    profile_database,
    profile_table,
    wilson_lower,
)
from repro_torch.discovery.infer import name_similarity
from repro_torch.discovery.profile import _sketch_columns
from repro_torch.relational import Table
from repro_torch.relational.table import NULL_KEY

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
from discovery_summary import make_dataset, summary  # noqa: E402

sys.path.pop(0)


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_executables_cold():
    """Empty the JAX package's process-wide executable store after this
    module: its own tests count the compiles of a cold request, and may
    run next in the same worker process."""
    yield
    jpipe.clear_executable_cache()


def _tables(arrays, capacity=None):
    """The same columns as a port table (CPU) and a JAX table."""
    return (Table.from_arrays(capacity=capacity, device="cpu", **arrays),
            jrel.Table.from_arrays(capacity=capacity, **arrays))


def _dbs(tables):
    """{name: arrays} as a port database and a JAX database."""
    pairs = {n: _tables(a) for n, a in tables.items()}
    return (Database({n: p[0] for n, p in pairs.items()}),
            jdbm.Database({n: p[1] for n, p in pairs.items()}))


def _profile_view(tp):
    """A table profile as plain values, without its wall time."""
    return {"name": tp.name, "rows": tp.rows, "capacity": tp.capacity,
            "stats_fingerprint": tp.stats_fingerprint,
            "columns": {c: dataclasses.asdict(p)
                        for c, p in sorted(tp.columns.items())}}


def _candidate_view(c):
    return dataclasses.astuple(c)


def _result_view(res):
    """Everything a discovery result holds but its wall times."""
    return {
        "profiles": {n: _profile_view(p)
                     for n, p in sorted(res.profiles.items())},
        "candidates": [_candidate_view(c) for c in res.candidates],
        "fks": [_candidate_view(c) for c in res.fks],
        "vertices": [dataclasses.astuple(v) for v in res.vertices],
        "edges": [(e.spec(), repr(e.signature)) for e in res.edges],
        "stats": res.stats, "params": res.params,
        "spec": res.model_spec(),
    }


# ---------------------------------------------------------------------------
# stage 1: profiling (KMV sketch)
# ---------------------------------------------------------------------------

def _sketch_case(name):
    rng = np.random.default_rng(7)
    if name == "cap_below_k":            # 100 slots < k = 256: padding
        cols = rng.integers(0, 50, (2, 100)).astype(np.int32)
        valid = np.ones(100, bool)
    elif name == "all_null":             # every live value is NULL_KEY
        cols = np.stack([np.full(300, NULL_KEY, np.int32),
                         rng.integers(0, 10, 300).astype(np.int32)])
        valid = np.ones(300, bool)
    elif name == "above_k":              # ~3000 distinct hashes > k
        cols = rng.integers(0, 3000, (3, 5000)).astype(np.int32)
        valid = np.ones(5000, bool)
    else:                                # negative keys, nulls, padding
        cols = rng.integers(-2**31, 2**31 - 1, (2, 1024)).astype(np.int32)
        cols[0, ::5] = NULL_KEY
        cols[1, 100:300] = cols[1, 0]
        valid = np.arange(1024) < 700
    return cols, valid


@pytest.mark.parametrize("case", ["cap_below_k", "all_null", "above_k",
                                  "negative_null_padding"])
@pytest.mark.parametrize("k", [256, 16])
def test_kmv_sketch_bit_equal_to_jax(case, k):
    cols, valid = _sketch_case(case)
    got = _sketch_columns(torch.from_numpy(cols), torch.from_numpy(valid), k)
    want = [np.asarray(x) for x in jprof._sketch_columns(cols, valid, k)]
    assert got[0].dtype == want[0].dtype == np.uint32
    assert got[0].tobytes() == want[0].tobytes()
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])


def test_kmv_ndv_exact_below_k_and_approx_above():
    rng = np.random.default_rng(0)
    small = rng.integers(0, 100, 20000).astype(np.int32)     # 100 << k=256
    big = rng.integers(0, 3000, 20000).astype(np.int32)      # 3000 >> k
    t, jt = _tables(dict(small=small, big=big))
    prof = profile_table("t", t, Database({"t": t}).stats["t"])
    assert prof.columns["small"].ndv == len(np.unique(small))  # exact
    true_big = len(np.unique(big))
    assert abs(prof.columns["big"].ndv - true_big) / true_big < 0.15
    jp = jprof.profile_table("t", jt, jdbm.Database({"t": jt}).stats["t"])
    assert _profile_view(prof) == _profile_view(jp)


def test_profile_key_detection_and_nulls():
    rng = np.random.default_rng(1)
    n = 2048
    t, jt = _tables(dict(
        pk=np.arange(n, dtype=np.int32),
        fk=rng.integers(0, 64, n).astype(np.int32),
        sparse=np.where(np.arange(n) % 4 == 0, NULL_KEY,
                        np.arange(n)).astype(np.int32),
        weight=rng.random(n).astype(np.float32)))
    prof = profile_table("t", t, Database({"t": t}).stats["t"])
    assert prof.columns["pk"].key_like()
    assert not prof.columns["fk"].key_like()       # uniqueness ~64/2048
    sp = prof.columns["sparse"]
    assert abs(sp.null_frac - 0.25) < 0.01
    assert not sp.key_like()                       # too many nulls
    assert prof.columns["weight"].dtype == "float"
    assert prof.key_columns() == ("pk",)
    jp = jprof.profile_table("t", jt, jdbm.Database({"t": jt}).stats["t"])
    assert _profile_view(prof) == _profile_view(jp)


def test_profile_database_covers_tables():
    db, jdb = _dbs({"a": dict(x=np.arange(8, dtype=np.int32)),
                    "b": dict(y=np.arange(8, dtype=np.int32))})
    profs = profile_database(db)
    assert set(profs) == {"a", "b"}
    assert profs["a"].rows == 8
    jprofs = jdisc.profile_database(jdb)
    assert {n: _profile_view(p) for n, p in profs.items()} == \
        {n: _profile_view(p) for n, p in jprofs.items()}


# ---------------------------------------------------------------------------
# stage 2: inference
# ---------------------------------------------------------------------------

def test_wilson_lower_rewards_sample_size():
    assert wilson_lower(0, 0) == 0.0
    assert wilson_lower(16, 16) < wilson_lower(512, 512)
    assert wilson_lower(512, 512) > 0.99
    assert wilson_lower(256, 512) == pytest.approx(0.5, abs=0.05)
    for s, n in ((0, 0), (3, 7), (16, 16), (256, 512), (512, 512)):
        assert wilson_lower(s, n) == jdisc.wilson_lower(s, n)


def test_name_similarity_ignores_generic_tokens():
    # "c_sk" vs "c_id" must match on "c", never on the generic sk/id
    assert name_similarity("c_sk", "c_id", "customer") == 1.0
    assert name_similarity("p_sk", "c_id", "customer") == 0.0
    assert name_similarity("rid", "o_id", "outlet") == 0.0   # all generic


def _fk_toy_arrays():
    """parent (64 unique keys) <- child.fk; child.noise is a decoy whose
    range escapes the parent's key space."""
    rng = np.random.default_rng(2)
    return {"parent": dict(pid=np.arange(64, dtype=np.int32),
                           payload=rng.integers(0, 5, 64).astype(np.int32)),
            "child": dict(rid=np.arange(512, dtype=np.int32),
                          fk=rng.integers(0, 64, 512).astype(np.int32),
                          noise=rng.integers(0, 100000,
                                             512).astype(np.int32))}


def test_infer_join_keys_compiled_counters():
    db, _ = _dbs(_fk_toy_arrays())
    compiler = PipelineCompiler(device="cpu")
    before = compiler.cache_info()
    fks, cands, checker = infer_join_keys(
        db, profile_database(db), compiler=compiler, use_name_hints=False)
    after = compiler.cache_info()
    assert checker.checks > 0
    assert checker.compiled_checks == checker.checks   # no eager fallback
    assert all(c.compiled for c in cands if c.sampled)
    # every check ran through the pipeline cache (hit or build miss)
    runs = (after["hits"] + after["misses"]) - (before["hits"]
                                               + before["misses"])
    assert runs == checker.checks
    accepted = {(c.child_table, c.child_col, c.parent_table, c.parent_col)
                for c in fks}
    assert ("child", "fk", "parent", "pid") in accepted
    assert not any(c.child_col == "noise" for c in fks)


def test_infer_eager_path_matches_compiled():
    db, _ = _dbs(_fk_toy_arrays())
    profs = profile_database(db)
    fks_c, _, chk_c = infer_join_keys(db, profs,
                                      compiler=PipelineCompiler(device="cpu"),
                                      use_name_hints=False)
    fks_e, _, chk_e = infer_join_keys(db, profs, compiler=None,
                                      use_name_hints=False)
    assert chk_e.compiled_checks == 0
    assert fk_pairs(fks_c) == fk_pairs(fks_e)
    conf_c = {c.pair(): c.confidence for c in fks_c}
    conf_e = {c.pair(): c.confidence for c in fks_e}
    assert conf_c == conf_e


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "eager"])
@pytest.mark.parametrize("hints", [False, True], ids=["anon", "hints"])
def test_candidates_match_jax(compiled, hints):
    """Every candidate's pair, sample, matched and confidence, the
    accepted set and the checker's counters equal the JAX package's."""
    db, jdb = _dbs(_fk_toy_arrays())
    fks, cands, chk = infer_join_keys(
        db, profile_database(db), use_name_hints=hints,
        compiler=PipelineCompiler(device="cpu") if compiled else None)
    jfks, jcands, jchk = jdisc.infer_join_keys(
        jdb, jdisc.profile_database(jdb), use_name_hints=hints,
        compiler=jpipe.PipelineCompiler() if compiled else None)
    assert [_candidate_view(c) for c in cands] == \
        [_candidate_view(c) for c in jcands]
    assert [c.pair() for c in fks] == [c.pair() for c in jfks]
    assert (chk.checks, chk.compiled_checks) == \
        (jchk.checks, jchk.compiled_checks)


# ---------------------------------------------------------------------------
# end-to-end recovery on the anonymized synthetic datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,size,min_precision,min_recall", [
    ("dblp", 1, 0.8, 1.0),
    ("imdb", 1, 0.99, 0.99),
    ("tpcds", 10, 0.75, 0.9),
])
def test_discovery_recovers_hand_models_like_jax(name, size, min_precision,
                                                 min_recall):
    db, truth_models, hand_queries = make_dataset("repro_torch", name, size,
                                                  device="cpu")
    jdb, jtruth, jhand = make_dataset("repro", name, size)
    adb, mapping = anonymize_columns(db)
    jadb, jmapping = jdisc.anonymize_columns(jdb)
    assert mapping == jmapping
    equiv = column_equivalence(adb)
    assert equiv == jdisc.column_equivalence(jadb)
    clear_executable_cache()
    jpipe.clear_executable_cache()
    res = discover(adb, compiler=PipelineCompiler(device="cpu"),
                   use_name_hints=False)
    jres = jdisc.discover(jadb, compiler=jpipe.PipelineCompiler(),
                          use_name_hints=False)

    # acceptance: every containment check ran as a compiled pipeline
    assert res.stats["all_compiled"]
    assert res.stats["pipeline_runs"] == res.stats["containment_checks"]

    pred = canonicalize_pairs(fk_pairs(res.fks), equiv)
    truth = canonicalize_pairs(model_fk_pairs(truth_models, mapping), equiv)
    precision, recall = precision_recall(pred, truth)
    assert precision >= min_precision, sorted(
        tuple(sorted(p)) for p in pred - truth)
    assert recall >= min_recall, sorted(
        tuple(sorted(p)) for p in truth - pred)

    # every hand-written edge query appears among the ranked candidates
    er = edge_recovery(hand_queries, res.edges, mapping, equiv=equiv)
    assert er["recall"] == 1.0, er["missing"]

    # the emitted spec is builder-ready
    model = model_from_spec(res.model_spec(top=5))
    assert len(model.edges) == 5

    # and all of it is the JAX package's result
    assert _result_view(res) == _result_view(jres)
    assert er == jdisc.edge_recovery(jhand, jres.edges, jmapping,
                                     equiv=equiv)
    assert summary("repro_torch", res, adb, mapping, truth_models,
                   hand_queries) == summary("repro", jres, jadb, jmapping,
                                            jtruth, jhand)


def test_discovery_with_name_hints_ranks_true_fk_first():
    db, _, _ = make_dataset("repro_torch", "dblp", 1, device="cpu")
    res = discover(db, compiler=PipelineCompiler(device="cpu"),
                   use_name_hints=True)
    pairs = fk_pairs(res.fks)
    assert frozenset({("paper", "v_sk"), ("venue", "v_id")}) in pairs
    assert frozenset({("wrote", "a_sk"), ("author", "a_id")}) in pairs
    jdb, _, _ = make_dataset("repro", "dblp", 1)
    jres = jdisc.discover(jdb, compiler=jpipe.PipelineCompiler(),
                          use_name_hints=True)
    assert [_candidate_view(c) for c in res.fks] == \
        [_candidate_view(c) for c in jres.fks]


# ---------------------------------------------------------------------------
# engine + caching
# ---------------------------------------------------------------------------

def test_engine_discover_caches_results_and_profiles():
    db, _, _ = make_dataset("repro_torch", "dblp", 1, device="cpu")
    eng = ExtractionEngine(db)
    r1 = eng.discover(use_name_hints=False)
    pipe1 = eng.compiler.cache_info()
    r2 = eng.discover(use_name_hints=False)
    pipe2 = eng.compiler.cache_info()
    assert r2 is r1                                # whole-result cache hit
    # and no new pipeline work ran for the warm call
    assert (pipe2["hits"], pipe2["misses"]) == (pipe1["hits"],
                                                pipe1["misses"])
    info = eng.cache_info()
    assert info["caches"]["discoveries"]["hits"] == 1
    assert info["requests"]["discovers"] == 2

    # different knobs re-run inference but reuse per-table profiles
    r3 = eng.discover(use_name_hints=False, accept_threshold=0.6)
    assert r3 is not r1
    info = eng.cache_info()
    assert info["caches"]["profiles"]["hits"] >= len(r1.profiles)

    # a mutation moves the fingerprint: discovery re-runs, and only the
    # churned table is re-profiled
    misses = info["caches"]["profiles"]["misses"]
    eng.db.insert_rows("paper", p_id=np.array([9999], np.int32),
                       v_sk=np.array([0], np.int32),
                       rid=np.array([9999], np.int32))
    r4 = eng.discover(use_name_hints=False)
    assert r4 is not r1
    assert eng.cache_info()["caches"]["profiles"]["misses"] == misses + 1
    fork = eng.fork(eng.db.snapshot())
    assert fork.discover(use_name_hints=False) is r4  # fork inherits it
    assert set(fork.cache_info()["caches"]) >= {"profiles", "discoveries"}
    eng.clear()
    assert eng.cache_info()["caches"]["discoveries"]["size"] == 0
    assert eng.cache_info()["caches"]["profiles"]["size"] == 0

    # the same calls on the JAX engine: equal results
    jdb, _, _ = make_dataset("repro", "dblp", 1)
    jeng = japi.ExtractionEngine(jdb)
    assert _result_view(jeng.discover(use_name_hints=False))["fks"] == \
        _result_view(r1)["fks"]


# ---------------------------------------------------------------------------
# satellite: spec round-trip with bit-identical extraction
# ---------------------------------------------------------------------------

def test_discovered_spec_roundtrip_bit_identical():
    db, _, _ = make_dataset("repro_torch", "dblp", 1, device="cpu")
    res = discover(db, compiler=PipelineCompiler(device="cpu"),
                   use_name_hints=False)
    spec = res.model_spec(top=6)

    m_spec = model_from_spec(spec)
    # hand-build the same model through the fluent builder API
    b = GraphModelBuilder(spec["name"])
    for v in spec["vertices"]:
        b.vertex(v["label"], table=v["table"], id_col=v["id_col"])
    for e in spec["edges"]:
        b.edge(e["label"], src=e["src"], dst=e["dst"],
               query=join_query(e["label"],
                                relations=[tuple(r) for r in e["relations"]],
                                joins=list(e["joins"]),
                                src=e["src_col"], dst=e["dst_col"]))
    m_hand = b.build()

    # and through the JSON serialization loop
    m_json = model_from_json(json.dumps(model_to_spec(m_spec)))

    eng = ExtractionEngine(db)
    fps = [eng.extract(m).graph.fingerprint()
           for m in (m_spec, m_hand, m_json)]
    assert fps[0] == fps[1] == fps[2]

    # the JAX package discovers the same spec and extracts the same graph
    jdb, _, _ = make_dataset("repro", "dblp", 1)
    jres = jdisc.discover(jdb, compiler=jpipe.PipelineCompiler(),
                          use_name_hints=False)
    assert jres.model_spec(top=6) == spec
    jfp = japi.ExtractionEngine(jdb).extract(
        japi.model_from_spec(spec)).graph.fingerprint()
    assert jfp == fps[0]


# ---------------------------------------------------------------------------
# serving + HTTP
# ---------------------------------------------------------------------------

def _discover_view(out):
    """A discover payload without its per-request and timing fields."""
    return {k: v for k, v in out.items()
            if k not in ("timings_s", "trace_id", "tenant", "coalesced",
                         "source", "leader_trace_id")}


def test_service_discover_payload_and_tenant_cache():
    from repro.data.dblp import dblp_model as jdblp_model
    from repro.serving import GraphService as JGraphService
    from repro_torch.data.dblp import dblp_model
    from repro_torch.serving import GraphService

    db, _, _ = make_dataset("repro_torch", "dblp", 1, device="cpu")
    with GraphService(db, {"dblp": dblp_model()}) as svc:
        out = svc.discover(use_name_hints=False, top=5)
        assert out["kind"] == "discover" and out["source"] == "computed"
        assert len(out["edges"]) == 5 and len(out["fks"]) >= 5
        assert out["stats"]["all_compiled"]
        json.dumps(out)                           # JSON-clean payload
        # the proposed spec is directly extractable through the service
        m = model_from_spec(out["model_spec"])
        ext = svc.extract(m)
        assert sum(ext["edges"].values()) > 0
        warm = svc.discover(use_name_hints=False, top=5)
        assert warm["source"] == "tenant-cache"
    jdb, _, _ = make_dataset("repro", "dblp", 1)
    clear_executable_cache()
    jpipe.clear_executable_cache()
    with JGraphService(jdb, {"dblp": jdblp_model()}) as jsvc:
        jout = jsvc.discover(use_name_hints=False, top=5)
        jext = jsvc.extract(japi.model_from_spec(jout["model_spec"]))
    view, jview = _discover_view(out), _discover_view(jout)
    for v in (view, jview):
        v["stats"].pop("executable_misses")   # process-wide store state
    assert view == jview
    assert (ext["fingerprint"], ext["edges"]) == \
        (jext["fingerprint"], jext["edges"])


def test_http_discover_endpoint():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from serve_graphs_torch import build_service, make_server
    finally:
        sys.path.pop(0)
    svc = build_service("dblp", device="cpu")
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/discover",
            data=json.dumps({"use_name_hints": False, "top": 5}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
        assert out["kind"] == "discover"
        assert len(out["edges"]) == 5
        assert out["model_spec"]["edges"]
        assert out["stats"]["all_compiled"]
        # the returned spec posts straight back to /v1/extract
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/extract",
            data=json.dumps({"model": out["model_spec"]}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            ext = json.loads(resp.read())
        assert ext["kind"] == "extract"
        assert set(ext["edges"]) == {e["label"] for e in out["edges"]}
        assert sum(ext["edges"].values()) > 0
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(10)
