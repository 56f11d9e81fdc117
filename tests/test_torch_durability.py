"""The port's durability layer, alone and against the JAX package, on the CPU.

Mirrors the JAX package's WAL, recovery and fault-injection tests (the
part without the serving layer) on the port, then holds the two packages
to one on-disk format and one fault-plan language:

* a WAL and a manifest written by ``repro`` are recovered by
  ``repro_torch.durability.recover_database``, and the reverse, with equal
  ``Database.fingerprint()``, equal digests and stats of every table, and
  an equal ``fingerprint()`` of the graph an engine extracts afterwards;
* the same fault plan JSON fires at the same sites, the same number of
  times, in both packages, and leaves both logs in the same state.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core.pipeline as jpipe
import repro.api as japi
import repro.core.database as jdbm
import repro.data as jdata
import repro.durability as jdur
import repro.durability.recovery as jrec
import repro.relational as jrel
from repro.relational.ops import table_digest as jdigest
import repro_torch.data as tdata
from repro_torch.api import ExtractionEngine, GraphModelBuilder
from repro_torch.core.database import Database, from_numpy_tables
from repro_torch.durability import (
    FatalFaultInjected,
    FaultInjected,
    FaultPlan,
    FaultRule,
    INJECTOR,
    RecoveryError,
    RetryableError,
    WALCorruption,
    WALError,
    faults,
    load_manifest,
    read_all,
    recover_database,
    replay_wal,
    restore_database,
    write_manifest,
)
from repro_torch.durability.recovery import load_graphs
from repro_torch.durability.wal import WriteAheadLog
from repro_torch.relational import Table
from repro_torch.relational.ops import table_digest as tdigest


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_executables_cold():
    """Empty the JAX package's process-wide executable store after this
    module: its own tests count the compiles of a cold request, and may
    run next in the same worker process."""
    yield
    jpipe.clear_executable_cache()


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.uninstall()
    jdur.faults.uninstall()
    yield
    faults.uninstall()
    jdur.faults.uninstall()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _social_arrays(n_people=32, n_follows=96, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "person": dict(rid=np.arange(n_people, dtype=np.int32),
                       p_id=np.arange(n_people, dtype=np.int32),
                       age=rng.integers(18, 24, n_people).astype(np.int32)),
        "follows": dict(rid=np.arange(n_follows, dtype=np.int32),
                        src_sk=rng.integers(0, n_people,
                                            n_follows).astype(np.int32),
                        dst_sk=rng.integers(0, n_people,
                                            n_follows).astype(np.int32))}


def make_social(**kw) -> Database:
    """The JAX serving tests' social database, on the port (CPU)."""
    return Database({n: Table.from_arrays(device="cpu", **cols)
                     for n, cols in _social_arrays(**kw).items()})


def make_social_jax(**kw) -> "jdbm.Database":
    return jdbm.Database({n: jrel.Table.from_arrays(**cols)
                          for n, cols in _social_arrays(**kw).items()})


def _follows_model(builder=GraphModelBuilder, name="social"):
    return (builder(name)
            .vertex("Person", table="person", id_col="p_id")
            .edge("Follows", src="Person", dst="Person",
                  relations=[("P1", "person"), ("F", "follows"),
                             ("P2", "person")],
                  joins=["P1.p_id = F.src_sk", "F.dst_sk = P2.p_id"],
                  src_col="P1.p_id", dst_col="P2.p_id")
            .build())


def _durable_db(dirpath, **kw) -> Database:
    db = make_social(**kw)
    db.attach_wal(str(dirpath))
    return db


def _db_digest(db) -> dict:
    """Per-table content digest (valid rows only) + recorded stats; the
    same bytes and the same stats repr for either package's database."""
    out = {}
    for name in sorted(db.tables):
        data = db.tables[name].to_numpy()
        out[name] = {col: data[col].tobytes() for col in sorted(data)}
        out[name]["__stats__"] = repr(db.stats[name])
    return out


def _grow_follows(db, n=4, seed=7):
    """Insert n fresh follows rows (either package's database)."""
    rng = np.random.default_rng(seed)
    base = int(_np(db.tables["follows"]["rid"]).max()) + 1
    people = int(_np(db.tables["person"]["rid"]).max()) + 1
    return db.insert_rows(
        "follows",
        rid=np.arange(base, base + n, dtype=np.int32),
        src_sk=rng.integers(0, people, n).astype(np.int32),
        dst_sk=rng.integers(0, people, n).astype(np.int32))


def _mutate_some(db, seed=3, n=5) -> None:
    _grow_follows(db, n=n, seed=seed)
    db.delete_where("follows", "rid", "<", 2)


# ---------------------------------------------------------------------------
# WAL: roundtrip, torn tail, corruption, rotation, monotonicity
# ---------------------------------------------------------------------------

def test_wal_full_replay_reconstructs_database(tmp_path):
    db = _durable_db(tmp_path)
    _mutate_some(db)
    _grow_follows(db, n=3, seed=11)
    want = _db_digest(db)
    epoch = db.epoch
    db.detach_wal()
    recovered, report = recover_database(str(tmp_path), make_social())
    assert report.path == "cold"
    assert recovered.epoch == epoch
    assert _db_digest(recovered) == want
    assert recovered.device == torch.device("cpu")


def test_wal_replay_is_idempotent(tmp_path):
    db = _durable_db(tmp_path)
    _mutate_some(db)
    want = _db_digest(db)
    db.detach_wal()
    first, _ = recover_database(str(tmp_path), make_social())
    again, _ = recover_database(str(tmp_path), make_social())
    assert _db_digest(first) == _db_digest(again) == want
    replayed, skipped, _ = replay_wal(first.snapshot(), str(tmp_path))
    assert replayed == 0 and skipped > 0


def test_wal_torn_tail_truncated_and_repair_sticks(tmp_path):
    db = _durable_db(tmp_path)
    _grow_follows(db, n=2, seed=1)
    _grow_follows(db, n=2, seed=2)
    db.detach_wal()
    (active,) = [f for f in os.listdir(tmp_path) if f.endswith(".open")]
    path = os.path.join(tmp_path, active)
    with open(path, "r+b") as f:          # tear the last record in half
        f.truncate(os.path.getsize(path) - 7)
    records, truncated = read_all(str(tmp_path), repair=True)
    assert truncated > 0
    epochs = [r.epoch for r in records]
    assert epochs == sorted(epochs)
    records2, truncated2 = read_all(str(tmp_path))
    assert truncated2 == 0 and [r.epoch for r in records2] == epochs
    wal = WriteAheadLog(str(tmp_path))
    assert wal.stats()["last_epoch"] == epochs[-1]
    wal.close()


def test_wal_sealed_segment_corruption_raises(tmp_path):
    wal = WriteAheadLog(str(tmp_path))
    wal.append_replace("t", 1, {"x": np.arange(4)}, capacity=4)
    assert wal.rotate()
    wal.close()
    (seg,) = [f for f in os.listdir(tmp_path) if f.endswith(".seg")]
    path = os.path.join(tmp_path, seg)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF          # flip one payload byte
    open(path, "wb").write(bytes(blob))
    with pytest.raises(WALCorruption):
        read_all(str(tmp_path))


def test_wal_epochs_strictly_monotonic(tmp_path):
    wal = WriteAheadLog(str(tmp_path))
    wal.append_replace("t", 3, {"x": np.arange(2)}, capacity=2)
    with pytest.raises(WALError):
        wal.append_replace("t", 3, {"x": np.arange(2)}, capacity=2)
    with pytest.raises(WALError):
        wal.append_replace("t", 1, {"x": np.arange(2)}, capacity=2)
    wal.append_replace("t", 4, {"x": np.arange(2)}, capacity=2)
    wal.close()


def test_wal_rotation_and_prune_respect_published_epoch(tmp_path):
    db = _durable_db(tmp_path)
    _grow_follows(db, n=2, seed=1)
    published = db.epoch
    db.wal.rotate()
    _grow_follows(db, n=2, seed=2)
    assert db.wal.prune(published) == 1
    assert db.wal.prune(published) == 0
    stats = db.wal.stats()
    assert stats["sealed_segments"] == 0 and stats["last_epoch"] == db.epoch
    db.detach_wal()


def test_wal_epoch_gap_after_overeager_prune_raises(tmp_path):
    db = _durable_db(tmp_path)
    _grow_follows(db, n=2, seed=1)
    db.wal.rotate()
    _grow_follows(db, n=2, seed=2)
    db.wal.prune(db.epoch - 1)
    db.detach_wal()
    with pytest.raises(RecoveryError, match="gap"):
        recover_database(str(tmp_path), make_social())


def test_durable_add_table_is_logged_and_replayed(tmp_path):
    db = _durable_db(tmp_path)
    _grow_follows(db, n=2, seed=1)
    db.add_table("extra", Table.from_arrays(
        device="cpu", capacity=8, k=np.arange(3, dtype=np.int32)))
    db.add_table("follows", Table.from_arrays(
        device="cpu", rid=np.arange(4, dtype=np.int32),
        src_sk=np.zeros(4, np.int32), dst_sk=np.ones(4, np.int32)))
    assert db.epoch == 3
    want = _db_digest(db)
    db.detach_wal()
    recovered, _ = recover_database(str(tmp_path), make_social())
    assert _db_digest(recovered) == want
    assert recovered.tables["extra"].capacity == 8
    assert not recovered.covers_epoch("follows", 1)


# ---------------------------------------------------------------------------
# manifest + checkpoint recovery
# ---------------------------------------------------------------------------

def test_manifest_restore_preserves_tables_stats_and_epoch(tmp_path):
    db = _durable_db(tmp_path)
    _mutate_some(db)
    manifest = write_manifest(str(tmp_path), db, {}, {})
    restored = restore_database(str(tmp_path), load_manifest(str(tmp_path)),
                                device="cpu")
    assert restored.epoch == db.epoch == manifest["epoch"]
    assert _db_digest(restored) == _db_digest(db)
    for name, table in db.tables.items():
        assert restored.tables[name].capacity == table.capacity
    db.detach_wal()


def test_prune_then_recover_from_checkpoint_plus_tail(tmp_path):
    db = _durable_db(tmp_path)
    _mutate_some(db)
    write_manifest(str(tmp_path), db, {}, {})
    db.wal.rotate()
    assert db.wal.prune(db.epoch) >= 1
    _grow_follows(db, n=4, seed=9)
    want = _db_digest(db)
    live = db.epoch
    db.detach_wal()
    recovered, report = recover_database(str(tmp_path), Database(),
                                         device="cpu")
    assert report.path == "checkpoint"
    assert report.replayed_records == 1 and report.live_epoch == live
    assert _db_digest(recovered) == want


def test_missing_manifest_cold_path_is_loud(tmp_path, caplog):
    db = _durable_db(tmp_path)
    _grow_follows(db, n=2, seed=1)
    db.detach_wal()
    with caplog.at_level("WARNING", logger="repro_torch.durability"):
        _, report = recover_database(str(tmp_path), make_social())
    assert report.path == "cold" and report.manifest_epoch is None
    assert any("no manifest" in r.message for r in caplog.records)


def test_recovery_graph_fingerprint_parity_via_engine(tmp_path):
    model = _follows_model()
    db = _durable_db(tmp_path)
    engine = ExtractionEngine(db.snapshot(), compiled=False)
    digest_p = engine.extract(model).graph.fingerprint()
    write_manifest(str(tmp_path), db, {}, {"social": digest_p})
    _mutate_some(db)
    ref = ExtractionEngine(db.snapshot(), compiled=False) \
        .extract(model).graph.fingerprint()
    db.detach_wal()
    recovered, report = recover_database(str(tmp_path), Database(),
                                         device="cpu")
    assert report.path == "checkpoint"
    got = ExtractionEngine(recovered.snapshot(), compiled=False) \
        .extract(model).graph.fingerprint()
    assert got == ref != digest_p


def test_checkpointed_graph_adopted_and_refreshed(tmp_path):
    """A restart adopts the checkpointed graph into a new engine, then an
    incremental refresh carries it across the replayed tail."""
    model = _follows_model()
    db = _durable_db(tmp_path)
    graph = ExtractionEngine(db.snapshot()).extract(model).graph
    write_manifest(str(tmp_path), db, {}, {"social": graph.fingerprint()},
                   graphs={"social": graph})
    _mutate_some(db)
    want = ExtractionEngine(db.snapshot()).extract(model).graph.fingerprint()
    db.detach_wal()
    manifest = load_manifest(str(tmp_path))
    restored = restore_database(str(tmp_path), manifest, device="cpu")
    graphs = load_graphs(str(tmp_path), manifest, device="cpu")
    assert graphs["social"].fingerprint() == graph.fingerprint()
    engine = ExtractionEngine(restored, auto_refresh=True)
    engine.adopt_extraction(model, graphs["social"])
    with pytest.raises(ValueError, match="planned methods"):
        engine.adopt_extraction(model, graphs["social"], method="ringo")
    replay_wal(restored, str(tmp_path))
    r = engine.extract(model)
    assert r.refresh.path == "delta"
    assert r.graph.fingerprint() == want


# ---------------------------------------------------------------------------
# fault-injection harness semantics
# ---------------------------------------------------------------------------

def test_fault_rule_times_and_after_windows(tmp_path):
    rule = FaultRule(site="wal.append", action="raise", times=1, after=1)
    db = _durable_db(tmp_path)
    with faults.inject(rule):
        _grow_follows(db, n=1, seed=1)
        with pytest.raises(FaultInjected):
            _grow_follows(db, n=1, seed=2)
        _grow_follows(db, n=1, seed=3)
    assert rule.matched == 3 and rule.fired == 1
    assert not INJECTOR.active()
    db.detach_wal()


def test_fault_plan_json_roundtrip_and_restore():
    plan = FaultPlan.from_json(
        '{"rules": [{"site": "wal.fsync", "action": "delay",'
        ' "delay_s": 0.001, "times": 2}]}')
    assert plan.rules[0].site == "wal.fsync"
    assert FaultPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    outer = FaultRule(site="snapshot.publish", action="raise")
    faults.install(FaultPlan(rules=[outer]))
    with faults.inject(plan):
        assert INJECTOR.stats()["rules"][0]["site"] == "wal.fsync"
    assert INJECTOR.stats()["rules"][0]["site"] == "snapshot.publish"
    faults.uninstall()
    assert not INJECTOR.active()
    with pytest.raises(ValueError):
        FaultRule(site="x", action="explode")


def test_fatal_fault_is_not_retryable():
    assert issubclass(FaultInjected, RetryableError)
    assert not issubclass(FatalFaultInjected, RetryableError)


def test_injected_fsync_failure_keeps_memory_and_disk_consistent(tmp_path):
    db = _durable_db(tmp_path)
    _grow_follows(db, n=1, seed=1)
    epoch = db.epoch
    rows = int(db.tables["follows"].valid.sum())
    stats = repr(db.stats["follows"])
    with faults.inject(FaultRule(site="wal.fsync", action="raise", times=1)):
        with pytest.raises(FaultInjected):
            db.insert_rows("follows", rid=np.array([900], np.int32),
                           src_sk=np.array([0], np.int32),
                           dst_sk=np.array([1], np.int32))
    assert db.epoch == epoch
    assert int(db.tables["follows"].valid.sum()) == rows
    assert repr(db.stats["follows"]) == stats
    assert len(db.changelog["follows"].entries) == 1
    records, truncated = read_all(str(tmp_path))
    assert truncated == 0 and records[-1].epoch == epoch
    db.insert_rows("follows", rid=np.array([900], np.int32),
                   src_sk=np.array([0], np.int32),
                   dst_sk=np.array([1], np.int32))
    assert db.epoch == epoch + 1
    db.detach_wal()
    recovered, _ = recover_database(str(tmp_path), make_social())
    assert _db_digest(recovered) == _db_digest(db)


def test_partial_write_fault_torn_then_recovered(tmp_path):
    db = _durable_db(tmp_path)
    _grow_follows(db, n=1, seed=1)
    want = _db_digest(db)
    epoch = db.epoch
    with faults.inject(FaultRule(site="wal.append", action="partial",
                                 fraction=0.4, times=1)):
        with pytest.raises(FaultInjected):
            _grow_follows(db, n=2, seed=2)
    assert db.epoch == epoch
    db.detach_wal()
    recovered, report = recover_database(str(tmp_path), make_social())
    assert report.truncated_bytes > 0
    assert _db_digest(recovered) == want


@pytest.mark.parametrize("action", ["raise", "raise_fatal"])
def test_engine_cache_fill_fault_loses_only_the_entry(action):
    model = _follows_model()
    engine = ExtractionEngine(make_social())
    error = FaultInjected if action == "raise" else FatalFaultInjected
    with faults.inject(FaultRule(site="engine.cache_fill", action=action)):
        with pytest.raises(error):
            engine.extract(model)
    assert engine.cache_info()["plans"] == 0
    r = engine.extract(model)                 # the retry rebuilds it
    assert not r.provenance.plan_cache_hit
    with faults.inject(FaultRule(site="engine.cache_fill", action=action)):
        with pytest.raises(error):
            engine.analyze(model, algorithm="degree_stats")
    assert engine.cache_info()["csrs"] == 0
    a = engine.analyze(model, algorithm="degree_stats")
    assert not a.provenance.csr_cache_hit
    assert engine.cache_info()["csrs"] == 1


# ---------------------------------------------------------------------------
# cross-package: one on-disk format, one fault-plan language
# ---------------------------------------------------------------------------

def _host_tables(db):
    return {t: {**{c: np.asarray(tab[c]) for c in tab.columns},
                "valid": np.asarray(tab.valid)}
            for t, tab in db.tables.items()}


def _tpcds_churn(db, rng, n_ins=40, n_del=25):
    n = int(_np(db.tables["store_sales"]["rid"]).max()) + 1
    db.insert_rows(
        "store_sales",
        rid=np.arange(n, n + n_ins, dtype=np.int32),
        c_sk=rng.integers(0, 500, n_ins).astype(np.int32),
        i_sk=rng.integers(0, 100, n_ins).astype(np.int32),
        p_sk=rng.integers(0, 16, n_ins).astype(np.int32),
        o_sk=rng.integers(0, 4, n_ins).astype(np.int32))
    live = np.flatnonzero(_np(db.tables["store_sales"].valid))
    mask = np.zeros(db.tables["store_sales"].capacity, dtype=bool)
    mask[rng.choice(live, n_del, replace=False)] = True
    db.delete_rows("store_sales", mask)
    db.delete_where("item", "i_id", ">", 97)


def _live_life(db, dirpath, extract, graph_fp):
    """Attach, churn, publish a manifest (with the graph), churn a tail,
    crash (detach): the same life for either package's database."""
    db.attach_wal(str(dirpath))
    _tpcds_churn(db, np.random.default_rng(1))
    graph = extract(db)
    write_manifest_fn = (jdur.write_manifest
                         if isinstance(db, jdbm.Database) else write_manifest)
    write_manifest_fn(str(dirpath), db, {}, {"fraud": graph_fp(graph)},
                      graphs={"fraud": graph})
    db.wal.rotate()
    _tpcds_churn(db, np.random.default_rng(2))
    db.detach_wal()


def _assert_recovered(recovered, live):
    assert recovered.epoch == live.epoch
    assert recovered.fingerprint() == live.fingerprint()
    for t in live.tables:
        assert recovered.tables[t].capacity == live.tables[t].capacity, t
        assert repr(recovered.stats[t]) == repr(live.stats[t]), t
    assert _db_digest(recovered) == _db_digest(live)


def test_jax_wal_and_manifest_recovered_by_port(tmp_path):
    jd = jdbm.Database(dict(jdata.make_tpcds(sf=1, seed=0).tables))
    jm = jdata.fraud_model("store")
    _live_life(jd, tmp_path,
               lambda d: japi.ExtractionEngine(d.snapshot()).extract(jm).graph,
               lambda g: g.fingerprint())
    want = japi.ExtractionEngine(jd.snapshot()).extract(jm).graph
    recovered, report = recover_database(str(tmp_path), Database(),
                                         device="cpu")
    assert report.path == "checkpoint" and report.replayed_records == 3
    _assert_recovered(recovered, jd)
    for t in jd.tables:
        assert tdigest(recovered.tables[t]) == jdigest(jd.tables[t]), t
    got = ExtractionEngine(recovered).extract(tdata.fraud_model("store"))
    assert got.graph.fingerprint() == want.fingerprint()
    # the checkpointed graph too
    manifest = load_manifest(str(tmp_path))
    graphs = load_graphs(str(tmp_path), manifest, device="cpu")
    assert graphs["fraud"].fingerprint() == manifest["graph_digests"]["fraud"]


def test_port_wal_and_manifest_recovered_by_jax(tmp_path):
    jbase = jdata.make_tpcds(sf=1, seed=0)
    td = from_numpy_tables(_host_tables(jbase), device="cpu")
    tm = tdata.fraud_model("store")
    _live_life(td, tmp_path,
               lambda d: ExtractionEngine(d.snapshot()).extract(tm).graph,
               lambda g: g.fingerprint())
    want = ExtractionEngine(td.snapshot()).extract(tm).graph
    recovered, report = jdur.recover_database(str(tmp_path), jdbm.Database())
    assert report.path == "checkpoint" and report.replayed_records == 3
    _assert_recovered(recovered, td)
    got = japi.ExtractionEngine(recovered).extract(jdata.fraud_model("store"))
    assert got.graph.fingerprint() == want.fingerprint()
    manifest = jdur.load_manifest(str(tmp_path))
    graphs = jrec.load_graphs(str(tmp_path), manifest)
    assert graphs["fraud"].fingerprint() == manifest["graph_digests"]["fraud"]
    # and the cold path: the full log replays in the JAX package alike
    os.unlink(os.path.join(tmp_path, "MANIFEST.json"))
    cold, report = jdur.recover_database(
        str(tmp_path), jdbm.Database(dict(jbase.tables)))
    assert report.path == "cold"
    _assert_recovered(cold, td)


PLAN = json.dumps({"seed": 7, "rules": [
    {"site": "wal.append", "action": "raise", "times": 1, "after": 1},
    {"site": "wal.fsync", "action": "raise", "times": 1, "after": 2},
    {"site": "wal.append", "action": "partial", "times": 1, "after": 4,
     "fraction": 0.3},
    {"site": "wal.rename", "action": "raise", "times": 1},
    {"site": "engine.cache_fill", "action": "raise", "times": 1},
    {"site": "snapshot.publish", "action": "raise", "times": 1},
]})


def _fault_life(db, wal_dir, fault_mod, engine_cls, model):
    """Mutations, a rotation and two extracts under the same plan; returns
    what each step did and the injector's log."""
    outcomes = []
    db.attach_wal(str(wal_dir))
    with fault_mod.inject(fault_mod.FaultPlan.from_json(PLAN)) as inj:
        for i in range(7):
            try:
                _grow_follows(db, n=1, seed=50 + i)
                outcomes.append("ok")
            except fault_mod.FaultInjected as e:
                outcomes.append(e.site)
            if i == 3:
                try:
                    db.wal.rotate()
                    outcomes.append("rotated")
                except fault_mod.FaultInjected as e:
                    outcomes.append(e.site)
        engine = engine_cls(db.snapshot())
        for _ in range(2):
            try:
                engine.extract(model)
                outcomes.append("extract")
            except fault_mod.FaultInjected as e:
                outcomes.append(e.site)
        stats = inj.stats()
    db.detach_wal()
    return outcomes, stats, db.epoch


def test_same_fault_plan_fires_alike_in_both_packages(tmp_path):
    from repro.api import GraphModelBuilder as JBuilder
    jd = make_social_jax()
    td = make_social()
    jout = _fault_life(jd, tmp_path / "jax", jdur.faults,
                       japi.ExtractionEngine, _follows_model(JBuilder))
    tout = _fault_life(td, tmp_path / "port", faults, ExtractionEngine,
                       _follows_model())
    assert tout == jout
    outcomes, stats, _ = tout
    assert "wal.append" in outcomes and "wal.fsync" in outcomes
    assert "wal.rename" in outcomes and "engine.cache_fill" in outcomes
    assert [r["fired"] for r in stats["rules"]] == [1, 1, 1, 1, 1, 0]
    # both logs hold the same records, and each package reads the other's
    for reader in (read_all, jdur.read_all):
        jrec, _ = reader(str(tmp_path / "jax"))
        trec, _ = reader(str(tmp_path / "port"))
        assert [(r.table, r.kind, r.epoch) for r in trec] == \
            [(r.table, r.kind, r.epoch) for r in jrec]
        for a, b in zip(trec, jrec):
            assert sorted(a.payload) == sorted(b.payload)
            for k in a.payload:
                assert a.payload[k].dtype == b.payload[k].dtype
                assert np.array_equal(a.payload[k], b.payload[k])
    assert _db_digest(td) == _db_digest(jd)
