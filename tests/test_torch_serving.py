"""The port's serving layer, alone and against the JAX package, on the CPU.

Every test of ``tests/test_serving.py`` and the serving tests of
``tests/test_durability.py`` have a counterpart here, with real thread
pools over a tiny social database:

* K concurrent identical requests execute exactly one extraction;
* a reader pinned to epoch E sees bit-identical graph digests while a
  writer builds and publishes later epochs, and every published
  fingerprint equals the JAX service's after the same mutations;
* an over-quota tenant is rejected or evicted without touching another
  tenant's requests or cached responses;
* the HTTP front end (``examples/serve_graphs_torch.py``) maps errors to
  the JAX front end's status codes and body shape;
* the three serving fault sites fire, deadlines and drain-on-close hold,
  and no pin or quota slot leaks;
* a ``durable_dir`` written by either package's service is recovered by
  the other's.

Payloads are compared with the JAX service's exactly (graph fingerprints,
vertex and edge counts, epochs), PageRank summaries to the relative
tolerance of ``tests/test_torch_graph.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time as _time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.database as jdbm
import repro.core.model as jmodel
import repro.core.pipeline as jpipe
import repro.durability as jdur
import repro.relational as jrel
import repro.serving as jserving
import repro.serving.service as jservice
from repro_torch.api.engine import ExtractionEngine, _LRUCache
from repro_torch.core.database import Database
from repro_torch.core.model import GraphModel
from repro_torch.durability import (
    FatalFaultInjected,
    FaultInjected,
    FaultRule,
    RecoveryError,
    RetryableError,
    faults,
)
from repro_torch.kernels import _build
from repro_torch.relational import Table
from repro_torch.serving import (
    AdmissionError,
    CoalescingScheduler,
    DeadlineExceeded,
    GraphService,
    QuotaExceeded,
    QuotaManager,
    ServiceClosed,
    Snapshot,
    SnapshotNotFound,
    SnapshotStore,
    TenantQuota,
    UnknownModel,
)
from repro_torch.serving.service import _summarize_values

ROOT = Path(__file__).resolve().parents[1]
PR_RTOL = 1e-5          # tests/test_torch_graph.py: PageRank against JAX


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_executables_cold():
    """Empty the JAX package's process-wide executable store after this
    module: its own tests count the compiles of a cold request."""
    yield
    jpipe.clear_executable_cache()


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.uninstall()
    jdur.faults.uninstall()
    yield
    faults.uninstall()
    jdur.faults.uninstall()


# ---------------------------------------------------------------------------
# tiny dataset: fast enough that every test runs the real engine
# ---------------------------------------------------------------------------

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


def make_social_jax(**kw):
    return jdbm.Database({n: jrel.Table.from_arrays(**cols)
                          for n, cols in _social_arrays(**kw).items()})


def _follows_model(name="social", reverse=False, model_cls=GraphModel):
    src_col, dst_col = ("P2.p_id", "P1.p_id") if reverse \
        else ("P1.p_id", "P2.p_id")
    return (model_cls.builder(name)
            .vertex("Person", table="person", id_col="p_id")
            .edge("Follows", src="Person", dst="Person",
                  relations=[("P1", "person"), ("F", "follows"),
                             ("P2", "person")],
                  joins=["P1.p_id = F.src_sk", "F.dst_sk = P2.p_id"],
                  src_col=src_col, dst_col=dst_col)
            .build())


def _sameage_model(name="sameage"):
    return (GraphModel.builder(name)
            .vertex("Person", table="person", id_col="p_id")
            .edge("SameAge", src="Person", dst="Person",
                  relations=[("P1", "person"), ("P2", "person")],
                  joins=["P1.age = P2.age"],
                  src_col="P1.p_id", dst_col="P2.p_id")
            .build())


def _service(**kw) -> GraphService:
    kw.setdefault("compiled", False)   # eager path, as the JAX tests
    return GraphService(make_social(), {"social": _follows_model()}, **kw)


def _jservice(**kw):
    kw.setdefault("compiled", False)
    return jserving.GraphService(
        make_social_jax(),
        {"social": _follows_model(model_cls=jmodel.GraphModel)}, **kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _grow_follows(target, n=4, seed=7):
    """Insert n fresh follows rows through a service of either package
    (``mutate``) or into a database of either package."""
    rng = np.random.default_rng(seed)
    tables = target._db.tables if hasattr(target, "mutate") \
        else target.tables
    base = int(_np(tables["follows"]["rid"]).max()) + 1
    people = int(_np(tables["person"]["rid"]).max()) + 1
    cols = {"rid": np.arange(base, base + n, dtype=np.int32),
            "src_sk": rng.integers(0, people, n).astype(np.int32),
            "dst_sk": rng.integers(0, people, n).astype(np.int32)}
    if hasattr(target, "mutate"):
        return target.mutate("follows", insert=cols)
    return target.insert_rows("follows", **cols)


def _wait_until(cond, timeout=10.0):
    """Spin until ``cond()`` — done-callbacks (tenant-cache records, quota
    releases) run in worker threads just after a future resolves."""
    deadline = _time.monotonic() + timeout
    while not cond():
        if _time.monotonic() > deadline:
            raise AssertionError("condition never became true")
        _time.sleep(0.005)


def _gate_engine_extract(service, epoch=None):
    """Make the served snapshot's extract block until the event is set."""
    with service._store.pin(epoch) as snap:
        engine = snap.engine
    gate = threading.Event()
    real = engine.extract

    def gated(*args, **kwargs):
        assert gate.wait(20), "test gate never opened"
        return real(*args, **kwargs)

    engine.extract = gated
    return gate


_PER_REQUEST = ("trace_id", "timings_s", "tenant", "coalesced", "source",
                "leader_trace_id")


def _payload_view(p):
    """A payload without per-request fields and wall times."""
    return {k: v for k, v in p.items() if k not in _PER_REQUEST}


# ---------------------------------------------------------------------------
# _LRUCache: access-time (not insertion-time) eviction order
# ---------------------------------------------------------------------------

def test_lru_cache_evicts_by_access_time():
    lru = _LRUCache(2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1          # touch: "a" is now MRU
    lru.put("c", 3)                   # pressure evicts LRU = "b", not "a"
    assert "a" in lru and "c" in lru and "b" not in lru
    assert lru.info() == {"size": 2, "capacity": 2, "hits": 1,
                          "misses": 0, "evictions": 1}


def test_lru_cache_miss_and_uncounted_get():
    lru = _LRUCache(4)
    assert lru.get("nope") is None and lru.misses == 1
    lru.put("k", "v")
    assert lru.get("k", count=False) == "v"
    assert lru.hits == 0              # bookkeeping scan: no counter skew


def test_csr_cache_hot_entry_survives_cold_pressure():
    """CSR cache eviction is LRU by access, not insertion."""
    engine = ExtractionEngine(make_social(), compiled=False, max_csrs=2)
    hot = _follows_model("hot")
    cold1 = _follows_model("cold1", reverse=True)
    cold2 = _sameage_model("cold2")

    engine.analyze(hot, algorithm="degree_stats")     # csrs: [hot]
    engine.analyze(cold1, algorithm="degree_stats")   # csrs: [hot, cold1]
    r = engine.analyze(hot, algorithm="degree_stats")  # touch hot -> MRU
    assert r.provenance.csr_cache_hit
    engine.analyze(cold2, algorithm="degree_stats")   # evicts cold1, NOT hot
    assert engine.cache_info()["caches"]["csrs"]["evictions"] == 1
    assert engine.analyze(
        hot, algorithm="degree_stats").provenance.csr_cache_hit
    assert not engine.analyze(
        cold1, algorithm="degree_stats").provenance.csr_cache_hit


def test_cache_info_shape():
    engine = ExtractionEngine(make_social(), compiled=False)
    engine.extract(_follows_model())
    info = engine.cache_info()
    for key in ("plans", "views", "csrs", "results", "executables",
                "executable_hits", "executable_misses", "pipeline_retries"):
        assert key in info
    assert info["epoch"] == 0
    for cache in ("plans", "views", "csrs", "results"):
        sub = info["caches"][cache]
        assert set(sub) == {"size", "capacity", "hits", "misses",
                            "evictions", "bytes", "byte_evictions"}
        assert sub["bytes"] == info["cache_bytes"][cache]
    assert info["requests"]["extracts"] == 1
    assert info["requests"]["full_extracts"] == 1
    jinfo = japi.ExtractionEngine(make_social_jax(), compiled=False)
    assert set(info["caches"]) == set(jinfo.cache_info()["caches"])


# ---------------------------------------------------------------------------
# CoalescingScheduler
# ---------------------------------------------------------------------------

def test_scheduler_single_flight_coalescing():
    sched = CoalescingScheduler(max_workers=2)
    gate = threading.Event()
    calls = []

    def work():
        gate.wait(10)
        calls.append(1)
        return "payload"

    futs, joined = zip(*[sched.submit_ex("k", work) for _ in range(8)])
    gate.set()
    assert [f.result(10) for f in futs] == ["payload"] * 8
    assert len({id(f) for f in futs}) == 1        # literally the same future
    assert joined == (False,) + (True,) * 7
    assert len(calls) == 1
    st = sched.stats()
    assert (st["submitted"], st["executed"], st["coalesced"]) == (8, 1, 7)
    sched.shutdown()


def test_scheduler_recomputes_after_completion():
    sched = CoalescingScheduler(max_workers=1)
    ran = []
    sched.submit("k", lambda: ran.append(1)).result(10)
    sched.submit("k", lambda: ran.append(1)).result(10)
    assert len(ran) == 2 and sched.stats()["coalesced"] == 0
    sched.shutdown()


def test_scheduler_queue_full_rejects_with_retry_after():
    sched = CoalescingScheduler(max_workers=1, max_queue=2)
    gate = threading.Event()
    f1 = sched.submit("a", gate.wait)     # running
    f2 = sched.submit("b", gate.wait)     # queued; pending = 2 = max_queue
    with pytest.raises(AdmissionError) as err:
        sched.submit("c", gate.wait)
    assert err.value.retry_after > 0
    # coalescing still works while the queue is full: no new work enqueued
    assert sched.submit("a", gate.wait) is f1
    gate.set()
    f1.result(10), f2.result(10)
    assert sched.submit("c", lambda: "ok").result(10) == "ok"
    st = sched.stats()
    assert st["rejected"] == 1 and st["pending"] == 0
    sched.shutdown()


def test_scheduler_failure_shared_and_key_released():
    sched = CoalescingScheduler(max_workers=1)
    gate = threading.Event()

    def boom():
        gate.wait(10)
        raise ValueError("nope")

    f1, j1 = sched.submit_ex("k", boom)
    f2, j2 = sched.submit_ex("k", boom)
    assert f1 is f2 and not j1 and j2
    gate.set()
    with pytest.raises(ValueError):
        f1.result(10)
    assert sched.stats()["failed"] == 1
    # the failed key left the in-flight map: a retry actually re-executes
    assert sched.submit("k", lambda: "fine").result(10) == "fine"
    sched.shutdown()


def test_scheduler_close_drains_queued_and_coalesced():
    """No follower future is ever left unresolved by close()."""
    sched = CoalescingScheduler(max_workers=1, max_queue=8)
    gate = threading.Event()
    f_lead = sched.submit("slow", lambda: (gate.wait(10), "done")[1])
    followers = [sched.submit("slow", lambda: "x") for _ in range(4)]
    assert all(f is f_lead for f in followers)   # K waiters, one future
    f_queued = sched.submit("other", lambda: "never-runs")

    closer = threading.Thread(target=lambda: sched.close(wait=True))
    closer.start()
    _wait_until(lambda: sched.stats()["closed"])
    gate.set()                                    # let the in-flight finish
    closer.join(10)
    assert not closer.is_alive()

    assert f_lead.result(5) == "done"             # in-flight completed
    with pytest.raises(ServiceClosed):            # queued failed fast
        f_queued.result(5)
    with pytest.raises(ServiceClosed):            # post-close submit
        sched.submit("new", lambda: 1)
    st = sched.stats()
    assert st["pending"] == 0 and st["inflight"] == 0
    assert st["drained"] == 1


def test_scheduler_deadline_admission_and_queue_expiry():
    sched = CoalescingScheduler(max_workers=1, max_queue=8)
    gate = threading.Event()
    sched.submit("slow", lambda: gate.wait(10))

    # admission: estimated queue wait already exceeds the budget
    sched._ewma_s = 5.0
    with pytest.raises(DeadlineExceeded) as err:
        sched.submit("fast", lambda: 1, deadline_s=0.001)
    assert err.value.stage == "admission" and err.value.retry_after > 0

    # queue expiry: admitted optimistically, but the worker frees too late
    sched._ewma_s = 0.0001
    fut = sched.submit("fast2", lambda: 2, deadline_s=0.05)
    _time.sleep(0.12)
    gate.set()
    with pytest.raises(DeadlineExceeded) as err2:
        fut.result(10)
    assert err2.value.stage == "queue"
    st = sched.stats()
    assert st["expired"] == 1 and st["rejected"] >= 1
    assert st["pending"] == 0 and st["inflight"] == 0
    sched.close()


def test_launch_counters_are_exact_under_threads():
    """The wrappers' launch counter takes a lock: 8 threads of 5,000
    counts each add up exactly (the service launches from its worker
    threads at once)."""
    def fn():
        pass

    fn.launches = 0
    threads = [threading.Thread(target=lambda: [
        _build.count_launch(fn) for _ in range(5000)]) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert fn.launches == 8 * 5000


# ---------------------------------------------------------------------------
# QuotaManager
# ---------------------------------------------------------------------------

def test_quota_inflight_cap_is_per_tenant():
    qm = QuotaManager(default=TenantQuota(max_inflight=2))
    qm.admit("a"), qm.admit("a")
    with pytest.raises(QuotaExceeded) as err:
        qm.admit("a")
    assert err.value.tenant == "a" and err.value.retry_after > 0
    qm.admit("b")                         # other tenant is unaffected
    qm.release("a")
    qm.admit("a")                         # slot freed -> readmitted
    st = qm.stats()
    assert st["a"]["rejections"] == 1 and st["b"]["rejections"] == 0


def test_quota_cache_eviction_stays_inside_tenant():
    qm = QuotaManager(default=TenantQuota(max_entries=2))
    qm.record("big", "shared-key", {"big": 1}, 10)
    for i in range(2):
        qm.record("small", f"k{i}", {"i": i}, 10)
    assert qm.cached("small", "k0") == {"i": 0}   # touch: k0 is MRU
    qm.record("small", "k2", {"i": 2}, 10)        # evicts k1, not k0
    assert qm.cached("small", "k0") is not None
    assert qm.cached("small", "k1") is None
    st = qm.stats()
    assert st["small"]["evictions"] == 1
    assert st["big"]["evictions"] == 0
    assert qm.cached("big", "shared-key") == {"big": 1}


def test_quota_byte_budget():
    qm = QuotaManager(default=TenantQuota(max_entries=99, max_bytes=100))
    qm.record("t", "a", "x", 60)
    qm.record("t", "b", "y", 60)          # 120 bytes > 100 -> evict "a"
    assert qm.cached("t", "a") is None and qm.cached("t", "b") == "y"
    assert qm.stats()["t"]["cache_bytes"] == 60


# ---------------------------------------------------------------------------
# SnapshotStore
# ---------------------------------------------------------------------------

def _snap(epoch):
    db = make_social()
    return Snapshot(epoch=epoch, db=db,
                    engine=ExtractionEngine(db, compiled=False))


def test_snapshot_store_pin_publish_retire():
    store = SnapshotStore(_snap(0), keep=1)
    with store.pin() as s0:
        assert s0.epoch == 0
        store.publish(_snap(1))           # swap while a reader holds epoch 0
        assert store.current_epoch() == 1
        assert s0.pins == 1 and s0.retired
        store.publish(_snap(2))           # epoch 0 pinned -> must survive
        assert store.epochs() == [0, 1, 2]
    store.publish(_snap(3))               # unpinned now: keep=1 drops oldest
    assert 0 not in store.epochs() and store.stats()["dropped"] >= 1


def test_snapshot_store_unknown_and_nonmonotonic():
    store = SnapshotStore(_snap(0))
    store.publish(_snap(2))
    with pytest.raises(SnapshotNotFound) as err:
        store.pin(7).__enter__()
    assert err.value.available == [0, 2]
    assert store.publish(_snap(2)).epoch == 2     # re-publish current: noop
    with pytest.raises(ValueError):
        store.publish(_snap(0))                   # going backwards is a bug


def test_snapshot_publish_fault_site_fires_before_the_swap():
    store = SnapshotStore(_snap(0))
    rule = FaultRule(site="snapshot.publish", action="raise", times=1)
    with faults.inject(rule):
        with pytest.raises(FaultInjected):
            store.publish(_snap(1))
    assert rule.fired == 1
    assert store.current_epoch() == 0 and store.epochs() == [0]


# ---------------------------------------------------------------------------
# GraphService: coalescing, MVCC isolation, tenant quotas
# ---------------------------------------------------------------------------

def test_summarize_values_matches_jax_on_the_same_array():
    rng = np.random.default_rng(3)
    for arr in (rng.random(17).astype(np.float32),
                rng.integers(0, 9, 11).astype(np.int32),
                np.zeros(0, np.float32), rng.random(5) > 0.5):
        want = jservice._summarize_values(arr)
        assert _summarize_values(torch.from_numpy(arr)) == want
        assert _summarize_values({"x": torch.from_numpy(arr)}) == \
            {"x": want}


def test_service_coalesces_concurrent_identical_requests():
    """K concurrent identical requests -> 1 extraction."""
    K = 6
    with _service(max_workers=4) as svc:
        gate = _gate_engine_extract(svc)
        pairs = [svc.submit_extract("social") for _ in range(K)]
        gate.set()
        payloads = [fut.result(30) for fut, _ in pairs]
        metas = [meta for _, meta in pairs]
        assert all(p is payloads[0] for p in payloads)   # shared object
        assert [m["coalesced"] for m in metas] == [False] + [True] * (K - 1)
        st = svc.stats()
        assert st["scheduler"]["executed"] == 1
        assert st["scheduler"]["coalesced"] == K - 1
        assert st["engine"]["requests"]["extracts"] == 1
        assert st["engine"]["requests"]["full_extracts"] == 1
    with _jservice() as jsvc:
        assert _payload_view(payloads[0]) == \
            _payload_view(jsvc.extract("social"))


def test_service_tenant_cache_serves_repeats():
    with _service() as svc:
        first = svc.extract("social", tenant="t")
        _wait_until(
            lambda: svc.stats()["tenants"]["t"]["cache_entries"] == 1)
        again = svc.extract("social", tenant="t")
        assert first["source"] == "computed"
        assert again["source"] == "tenant-cache"
        assert again["fingerprint"] == first["fingerprint"]
        assert svc.stats()["tenants"]["t"]["hits"] == 1


def test_service_reader_pinned_epoch_is_bit_identical_under_writer():
    """Epoch-E reads identical during E+1 builds and after the swaps; each
    published epoch is the JAX service's after the same mutations."""
    with _service(max_workers=4, keep_snapshots=8) as svc, \
            _jservice(keep_snapshots=8) as jsvc:
        base = svc.extract("social", tenant="reader")
        e0, fp0 = base["epoch"], base["fingerprint"]
        assert fp0 == jsvc.extract("social")["fingerprint"]
        stop = threading.Event()
        failures = []

        def reader():
            while not stop.is_set():
                r = svc.extract("social", tenant="reader", epoch=e0,
                                timeout=30)
                if (r["epoch"], r["fingerprint"]) != (e0, fp0):
                    failures.append(r)
                    return

        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        published = []
        for i in range(3):                       # writer: mutate + publish
            _grow_follows(svc, n=3, seed=100 + i)
            published.append(svc.refresh())
        stop.set()
        for t in threads:
            t.join(60)
        assert not failures, f"pinned reader saw torn state: {failures[0]}"
        assert all(p["path"] == "published" for p in published)

        # after the swaps: latest differs, pinned epoch still bit-identical
        latest = svc.extract("social", tenant="reader")
        assert latest["epoch"] > e0 and latest["fingerprint"] != fp0
        pinned = svc.extract("social", tenant="fresh-tenant", epoch=e0)
        assert pinned["fingerprint"] == fp0
        # parity: the published graph equals a from-scratch oracle extract
        oracle = ExtractionEngine(
            Database(dict(svc._db.tables)), compiled=False).extract(
                _follows_model())
        assert latest["fingerprint"] == oracle.graph.fingerprint()

        # the JAX service, the same three mutations and publishes
        for i in range(3):
            _grow_follows(jsvc, n=3, seed=100 + i)
            assert jsvc.refresh()["path"] == "published"
        jlatest = jsvc.extract("social")
        assert _payload_view(jlatest) == _payload_view(latest)


def test_service_refresh_noop_and_models_paths():
    with _service() as svc:
        assert svc.refresh()["path"] == "noop"
        _grow_follows(svc, n=2)
        out = svc.refresh()
        assert out["path"] == "published"
        assert set(out["models"]) == {"social"}
        assert svc.stats()["served_epoch"] == out["epoch"]


def test_service_quota_rejection_isolated_per_tenant():
    """An over-quota tenant sheds load; others are unaffected."""
    quotas = {"small": TenantQuota(max_inflight=1)}
    with _service(max_workers=4, tenant_quotas=quotas) as svc:
        gate = _gate_engine_extract(svc)
        fut_small, _ = svc.submit_extract("social", tenant="small")
        with pytest.raises(QuotaExceeded) as err:
            svc.submit_extract("social", tenant="small")
        assert err.value.tenant == "small" and err.value.retry_after > 0
        # an unconstrained tenant is admitted and coalesces onto the work
        fut_big, meta_big = svc.submit_extract("social", tenant="big")
        assert meta_big["coalesced"]
        gate.set()
        assert fut_small.result(30) is fut_big.result(30)
        st = svc.stats()["tenants"]
        assert st["small"]["rejections"] == 1
        assert st["big"]["rejections"] == 0 and st["big"]["admitted"] == 1


def test_service_quota_eviction_isolated_per_tenant():
    quotas = {"small": TenantQuota(max_entries=2)}
    with _service(tenant_quotas=quotas) as svc:
        svc.extract("social", tenant="big")
        for method in ("extgraph", "extgraph-oj", "extgraph-mv"):
            svc.extract("social", method=method, tenant="small")
        _wait_until(lambda: svc.stats()["tenants"]["small"]["evictions"] == 1)
        st = svc.stats()["tenants"]
        assert st["small"]["evictions"] == 1
        assert st["small"]["cache_entries"] == 2
        assert st["big"]["evictions"] == 0
        assert svc.extract("social", tenant="big")["source"] == "tenant-cache"


def test_service_admission_backpressure():
    with _service(max_workers=1, max_queue=1) as svc:
        gate = _gate_engine_extract(svc)
        fut, _ = svc.submit_extract("social")
        with pytest.raises(AdmissionError) as err:
            svc.submit_extract("social", method="extgraph-oj")
        assert err.value.retry_after > 0
        gate.set()
        fut.result(30)
        # the rejected caller's quota slot was rolled back at the door
        _wait_until(
            lambda: svc.stats()["tenants"]["public"]["inflight"] == 0)


def _assert_values_match(got, want):
    """Summaries of one algorithm's output: shape and dtype exact, the
    statistics to PageRank's relative tolerance."""
    assert (got["shape"], got["dtype"]) == (want["shape"], want["dtype"])
    for k in ("min", "max", "mean"):
        assert got[k] == pytest.approx(want[k], rel=PR_RTOL, abs=0)


def test_service_unknown_model_and_analyze():
    with _service() as svc, _jservice() as jsvc:
        with pytest.raises(UnknownModel):
            svc.extract("nope")
        out = svc.analyze("social", algorithm="pagerank")
        assert out["kind"] == "analyze" and out["algorithm"] == "pagerank"
        assert "digest" in out["values"] and out["values"]["shape"][0] > 0
        # same epoch + params: coalesced-or-cached path, digest identical
        again = svc.analyze("social", algorithm="pagerank")
        assert again["values"]["digest"] == out["values"]["digest"]
        json.dumps(out)                      # payload is JSON-ready
        jout = jsvc.analyze("social", algorithm="pagerank")
        assert out["fingerprint"] == jout["fingerprint"]
        _assert_values_match(out["values"], jout["values"])
        # integer algorithms: the whole payload is the JAX service's
        for algo in ("wcc", "degree_stats"):
            got = svc.analyze("social", algorithm=algo)
            want = jsvc.analyze("social", algorithm=algo)
            assert _payload_view(got) == _payload_view(want), algo


def test_service_stats_shape():
    with _service() as svc:
        svc.extract("social")
        st = svc.stats()
        assert st["served_epoch"] == 0 and st["live_epoch"] == 0
        assert st["models"] == ["social"]
        assert st["scheduler"]["max_workers"] == 4
        assert "caches" in st["engine"] and "requests" in st["engine"]
        assert st["snapshots"]["current_epoch"] == 0
        assert st["persistent_compilation_cache"] is None or \
            isinstance(st["persistent_compilation_cache"], str)
        with _jservice() as jsvc:
            jsvc.extract("social")
            assert set(st) == set(jsvc.stats())


# ---------------------------------------------------------------------------
# HTTP front end (examples/serve_graphs_torch.py)
# ---------------------------------------------------------------------------

class _Http:
    def __init__(self, url, service):
        self.url = url
        self.service = service


def _serve(svc):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from serve_graphs_torch import make_server
    finally:
        sys.path.pop(0)
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    return server, thread, f"http://{host}:{port}"


@pytest.fixture()
def http_server():
    svc = _service(max_workers=2)
    server, thread, url = _serve(svc)
    try:
        yield _Http(url, svc)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(10)


def _http(url, payload=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_extract_mutate_refresh_roundtrip(http_server):
    url = http_server.url
    status, health = _http(f"{url}/healthz")
    assert status == 200 and health["ok"]

    status, models = _http(f"{url}/v1/models")
    assert status == 200 and models["models"] == ["social"]

    status, first = _http(f"{url}/v1/extract", {"model": "social"},
                          headers={"X-Tenant": "alice"})
    assert status == 200 and first["epoch"] == 0
    assert first["tenant"] == "alice"
    assert sum(first["edges"].values()) > 0

    status, out = _http(f"{url}/v1/mutate", {
        "table": "follows",
        "insert": {"rid": [1000, 1001], "src_sk": [0, 1], "dst_sk": [2, 3]}})
    assert status == 200 and out["live_epoch"] > out["served_epoch"]

    status, pub = _http(f"{url}/v1/refresh", {})
    assert status == 200 and pub["path"] == "published"

    status, second = _http(f"{url}/v1/extract", {"model": "social"})
    assert status == 200 and second["epoch"] == pub["epoch"]
    assert second["fingerprint"] != first["fingerprint"]

    # pinned read of the pre-mutation epoch is still served bit-identically
    status, pinned = _http(f"{url}/v1/extract",
                           {"model": "social", "epoch": 0})
    assert status == 200 and pinned["fingerprint"] == first["fingerprint"]

    status, st = _http(f"{url}/v1/stats")
    assert status == 200 and st["served_epoch"] == pub["epoch"]
    assert "alice" in st["tenants"]

    # the JAX service after the same mutation serves the same graph
    with _jservice() as jsvc:
        jsvc.mutate("follows", insert={
            "rid": np.array([1000, 1001]), "src_sk": np.array([0, 1]),
            "dst_sk": np.array([2, 3])})
        assert jsvc.refresh()["path"] == "published"
        assert _payload_view(jsvc.extract("social")) == \
            _payload_view(second)


def test_http_error_mapping(http_server):
    url = http_server.url
    status, body = _http(f"{url}/v1/extract", {"model": "nope"})
    assert status == 404 and "unknown model" in body["error"]

    status, body = _http(f"{url}/v1/extract", {})
    assert status == 400 and "missing field" in body["error"]

    status, body = _http(f"{url}/v1/extract",
                         {"model": "social", "epoch": 999})
    assert status == 410 and body["available"] == [0]

    status, body = _http(f"{url}/v1/nope", {})
    assert status == 404


def test_http_quota_returns_429_with_retry_after(http_server):
    http_server.service._quotas.set_quota(
        "throttled", TenantQuota(max_inflight=0))
    req = urllib.request.Request(
        f"{http_server.url}/v1/extract",
        data=json.dumps({"model": "social"}).encode(),
        headers={"X-Tenant": "throttled"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 429
    assert float(err.value.headers["Retry-After"]) > 0
    # other tenants keep being served
    status, _ = _http(f"{http_server.url}/v1/extract", {"model": "social"})
    assert status == 200


@pytest.fixture()
def http_server_tight():
    """max_workers=1 / max_queue=2: backpressure is easy to provoke."""
    svc = _service(max_workers=1, max_queue=2)
    server, thread, url = _serve(svc)
    try:
        yield _Http(url, svc)
    finally:
        faults.uninstall()
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(10)


def _assert_error_shape(body, retryable, with_retry_after=False):
    assert {"error", "retryable", "trace_id"} <= set(body)
    assert body["retryable"] is retryable
    assert isinstance(body["trace_id"], str) and body["trace_id"]
    if with_retry_after:
        assert body["retry_after"] > 0


def test_http_error_bodies_are_structured(http_server_tight):
    url = http_server_tight.url
    svc = http_server_tight.service

    # quota exhausted -> 429, retryable, Retry-After
    svc._quotas.set_quota("throttled", TenantQuota(max_inflight=0))
    status, body = _http(f"{url}/v1/extract", {"model": "social"},
                         headers={"X-Tenant": "throttled"})
    assert status == 429
    _assert_error_shape(body, True, with_retry_after=True)

    # retired/unpublished epoch -> 410, not retryable
    status, body = _http(f"{url}/v1/extract",
                         {"model": "social", "epoch": 999})
    assert status == 410
    _assert_error_shape(body, False)
    assert body["available"] == [0]

    # unknown model -> 404; bad request -> 400
    status, body = _http(f"{url}/v1/extract", {"model": "nope"})
    assert status == 404
    _assert_error_shape(body, False)
    status, body = _http(f"{url}/v1/extract", {})
    assert status == 400
    _assert_error_shape(body, False)

    # occupy the single worker so queue-level errors are reachable
    gate = _gate_engine_extract(svc)
    results = {}

    def held(name, path, payload):
        results[name] = _http(f"{url}{path}", payload)

    leader = threading.Thread(target=held, args=(
        "leader", "/v1/extract", {"model": "social"}))
    leader.start()
    _wait_until(lambda: svc._scheduler.stats()["pending"] == 1)

    # blown deadline at admission -> 504, retryable
    status, body = _http(f"{url}/v1/extract",
                         {"model": "social", "method": "gqfast",
                          "deadline_s": 0.0001})
    assert status == 504
    _assert_error_shape(body, True, with_retry_after=True)
    assert body["stage"] == "admission"

    # fill the queue, then overflow -> 429, retryable, Retry-After
    waiter = threading.Thread(target=held, args=(
        "waiter", "/v1/analyze",
        {"model": "social", "algorithm": "degree_stats"}))
    waiter.start()
    _wait_until(lambda: svc._scheduler.stats()["pending"] == 2)
    status, body = _http(f"{url}/v1/analyze",
                         {"model": "social", "algorithm": "pagerank"})
    assert status == 429
    _assert_error_shape(body, True, with_retry_after=True)

    gate.set()
    leader.join(30)
    waiter.join(30)
    assert results["leader"][0] == 200 and results["waiter"][0] == 200

    # injected fatal worker fault -> 500, not retryable
    with faults.inject(FaultRule(site="scheduler.worker",
                                 action="raise_fatal", times=1)):
        status, body = _http(f"{url}/v1/analyze",
                             {"model": "social", "algorithm": "pagerank",
                              "params": {"iterations": 3}})
    assert status == 500
    _assert_error_shape(body, False)

    # injected transient worker fault -> 503, retryable
    with faults.inject(FaultRule(site="scheduler.worker",
                                 action="raise", times=1)):
        status, body = _http(f"{url}/v1/extract",
                             {"model": "social", "method": "gqfast"})
    assert status == 503
    _assert_error_shape(body, True)

    # the service is not wedged by any of the above
    status, body = _http(f"{url}/v1/extract", {"model": "social"})
    assert status == 200
    assert svc._store.pinned_epochs() == []


def test_coalesced_requests_link_leader_trace():
    from repro_torch import obs

    with _service(max_workers=2, compiled=True) as svc:
        gate = _gate_engine_extract(svc)
        K = 5
        futs = [svc.submit_extract("social", tenant=f"t{i}",
                                   request_id=f"torch-req-{i}")
                for i in range(K)]
        gate.set()
        for fut, _ in futs:
            fut.result(timeout=60)
        metas = [meta for _, meta in futs]
        joined = [m for m in metas if m["coalesced"]]
        leaders = [m for m in metas if not m["coalesced"]]
        assert len(leaders) == 1 and len(joined) == K - 1
        leader_tid = leaders[0]["trace_id"]
        assert leader_tid == "torch-req-0"
        assert all(m["leader_trace_id"] == leader_tid for m in joined)
        leader_names = {s["name"] for s in obs.TRACER.get(leader_tid)}
        assert {"serve.extract", "engine.extract"} <= leader_names
        for m in joined:
            _wait_until(lambda: obs.TRACER.get(m["trace_id"]))
            spans = obs.TRACER.get(m["trace_id"])
            assert spans[0]["name"] == "coalesced.follow"
            assert spans[0]["attrs"]["links"] == leader_tid
            assert spans[0]["category"] == "queue"


def test_http_explain_traces_metrics_and_chrome():
    """The observability routes of the front end: EXPLAIN (ANALYZE), the
    trace list, one trace as JSON and as a Chrome export, the metrics
    registry as JSON and as Prometheus text, a 404 for a missing trace."""
    svc = _service(max_workers=2, compiled=True)
    server, thread, base = _serve(svc)
    try:
        status, out = _http(f"{base}/v1/explain", {"model": "social"},
                            headers={"X-Request-Id": "torch-explain-1"})
        assert status == 200 and out["kind"] == "explain"
        assert "PLAN" in out["text"] and out["report"]["units"]
        status, analyzed = _http(f"{base}/v1/explain",
                                 {"model": "social", "analyze": True},
                                 headers={"X-Request-Id": "torch-explain-2"})
        assert status == 200 and analyzed["analyze"]
        steps = [st for u in (analyzed["report"]["views"]
                              + analyzed["report"]["units"])
                 for st in u["steps"]]
        assert steps and all(st["actual_rows"] is not None for st in steps)

        status, listing = _http(f"{base}/v1/traces?limit=5")
        assert status == 200 and "torch-explain-2" in {
            t["trace_id"] for t in listing["traces"]}
        status, tr = _http(f"{base}/v1/trace/torch-explain-2")
        assert status == 200 and tr["summary"]["root"] == "serve.explain"
        with urllib.request.urlopen(
                f"{base}/v1/trace/torch-explain-2?format=chrome") as r:
            assert r.headers["Content-Disposition"] == (
                'attachment; filename="trace-torch-explain-2.json"')
            assert json.loads(r.read())["traceEvents"]
        status, snap = _http(f"{base}/v1/metrics")
        assert status == 200 and "serving_requests_total" in snap
        with urllib.request.urlopen(
                f"{base}/v1/metrics?format=prometheus") as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            for line in r.read().decode().splitlines():
                if line and not line.startswith("#"):
                    float(line.rpartition(" ")[2])   # every sample parses
        status, body = _http(f"{base}/v1/trace/no-such-trace")
        assert status == 404 and body["list"] == "/v1/traces"
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(10)


# ---------------------------------------------------------------------------
# persistent compilation cache: the kernels' build directory (opt-in flag;
# subprocesses keep this process's build directory untouched)
# ---------------------------------------------------------------------------

def test_persistent_compilation_cache_flag(tmp_path):
    code = textwrap.dedent("""
        import sys
        from pathlib import Path
        from repro_torch.core.pipeline import (
            enable_persistent_compilation_cache,
            persistent_compilation_cache_dir,
        )
        from repro_torch.kernels import _build
        dir_a, dir_b = sys.argv[1], sys.argv[2]
        default = _build.BUILD_DIR
        assert default.parts[-2:] == ("build", "kernels"), default
        assert persistent_compilation_cache_dir() is None
        assert enable_persistent_compilation_cache(None) is None  # opt-in
        assert _build.BUILD_DIR == default            # nothing changed
        assert enable_persistent_compilation_cache(dir_a) == dir_a
        assert persistent_compilation_cache_dir() == dir_a
        assert _build.BUILD_DIR == Path(dir_a)
        assert _build._target("bloom").parent == Path(dir_a)
        assert enable_persistent_compilation_cache(dir_a) == dir_a  # idem
        assert enable_persistent_compilation_cache(None) is None
        assert persistent_compilation_cache_dir() == dir_a  # unchanged
        assert enable_persistent_compilation_cache(dir_b) == dir_b  # repoint
        assert _build.BUILD_DIR == Path(dir_b)
        print("OK")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_COMPILATION_CACHE", None)
    out = subprocess.run(
        [sys.executable, "-c", code,
         str(tmp_path / "cache_a"), str(tmp_path / "cache_b")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
    assert (tmp_path / "cache_a").is_dir()


def test_persistent_cache_env_var_reaches_engine_and_service(tmp_path):
    code = textwrap.dedent("""
        import os
        from pathlib import Path
        from repro_torch.api.engine import ExtractionEngine
        from repro_torch.core.database import Database
        from repro_torch.core.pipeline import persistent_compilation_cache_dir
        from repro_torch.kernels import _build
        from repro_torch.relational import Table
        from repro_torch.serving import GraphService
        assert persistent_compilation_cache_dir() is None
        ExtractionEngine(Database({}))       # ctor picks up the env var
        want = os.environ["REPRO_COMPILATION_CACHE"]
        assert persistent_compilation_cache_dir() == want
        assert _build.BUILD_DIR == Path(want)
        db = Database({"t": Table.from_arrays(device="cpu", x=[1, 2])})
        with GraphService(db, {}) as svc:
            assert svc.stats()["persistent_compilation_cache"] == want
        print("OK")
    """)
    cache_dir = str(tmp_path / "env_cache")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "REPRO_COMPILATION_CACHE": cache_dir}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


# ---------------------------------------------------------------------------
# graceful degradation: deadlines, drain-on-close, pin-leak guard
# ---------------------------------------------------------------------------

def test_service_close_resolves_every_coalesced_waiter():
    """K coalesced waiters at close — all resolve."""
    svc = _service(max_workers=1)
    gate = _gate_engine_extract(svc)
    lead, meta = svc.submit_extract("social")
    waiters = [svc.submit_extract("social")[0] for _ in range(4)]
    assert all(w is lead for w in waiters)
    queued, _ = svc.submit_analyze("social", algorithm="degree_stats")
    assert queued is not lead

    closer = threading.Thread(target=svc.close)
    closer.start()
    _wait_until(lambda: svc._scheduler.stats()["closed"])
    gate.set()
    closer.join(15)
    assert not closer.is_alive()

    payload = lead.result(5)                      # leader + followers: data
    assert payload["kind"] == "extract"
    with pytest.raises(ServiceClosed):            # queued-but-unstarted
        queued.result(5)
    with pytest.raises(ServiceClosed):            # terminal for new work
        svc.analyze("social", algorithm="pagerank", iterations=2)
    # every pin released, every quota slot returned
    assert svc._store.pinned_epochs() == []
    _wait_until(lambda: svc._quotas.stats()["public"]["inflight"] == 0)


def test_snapshot_pins_balance_on_every_failure_path():
    """Pins drain on worker faults and deadlines."""
    svc = _service(max_workers=1)
    store = svc._store
    assert "pinned_epochs" in store.stats()

    with store.pin() as snap:                     # live pin is visible
        assert store.pinned_epochs() == [snap.epoch]
    assert store.pinned_epochs() == []

    # failure path 1: the worker raises mid-request
    rule = FaultRule(site="scheduler.worker", action="raise_fatal", times=1)
    with faults.inject(rule):
        with pytest.raises(FatalFaultInjected):
            svc.extract("social", timeout=30)
    assert rule.fired == 1
    assert store.pinned_epochs() == []

    # failure path 2: an admitted request expires in the queue
    gate = _gate_engine_extract(svc)
    lead, _ = svc.submit_extract("social")
    svc._scheduler._ewma_s = 0.0001    # optimistic estimate: admit it
    expired, _ = svc.submit_analyze("social", algorithm="degree_stats",
                                    deadline_s=0.02)
    _time.sleep(0.08)
    gate.set()
    with pytest.raises(DeadlineExceeded):
        expired.result(10)
    lead.result(10)
    _wait_until(lambda: store.pinned_epochs() == [])
    _wait_until(lambda: svc._quotas.stats()["public"]["inflight"] == 0)
    svc.close()


# ---------------------------------------------------------------------------
# durable serving, degraded refresh, recovery verification
# (the serving tests of tests/test_durability.py)
# ---------------------------------------------------------------------------

def _durable_service(tmp_path, **kw) -> GraphService:
    kw.setdefault("compiled", False)
    return GraphService(make_social(), {"social": _follows_model()},
                        durable_dir=str(tmp_path), **kw)


def _refresh_until_published(svc, timeout=5.0):
    deadline = _time.monotonic() + timeout
    while _time.monotonic() < deadline:
        out = svc.refresh()
        if out["path"] in ("published", "noop"):
            return out
        _time.sleep(min(0.05, out.get("retry_in_s") or 0.05))
    raise AssertionError("refresh never recovered")


def test_service_crash_recovery_bit_identical(tmp_path):
    svc = _durable_service(tmp_path)
    svc.extract("social")
    _grow_follows(svc, n=3, seed=5)
    assert svc.refresh()["path"] == "published"     # manifest at P
    _grow_follows(svc, n=2, seed=6)                 # unpublished tail
    ref_db = svc._db.snapshot()
    ref = ExtractionEngine(ref_db, compiled=False) \
        .extract(_follows_model()).graph.fingerprint()
    svc._db.detach_wal()                            # simulate SIGKILL

    svc2 = GraphService(Database(), compiled=False,
                        durable_dir=str(tmp_path), device="cpu")
    assert svc2.recovery.path == "checkpoint"
    assert svc2.recovery.verified["social"]         # digest parity held
    assert "social" in svc2.models()                # registry from manifest
    svc2.refresh()
    assert svc2.extract("social")["fingerprint"] == ref
    assert svc2.healthz()["recovery"]["replayed_records"] == 1
    svc2.close()


def test_service_recovery_rejects_digest_mismatch(tmp_path):
    svc = _durable_service(tmp_path)
    _grow_follows(svc, n=2, seed=5)
    assert svc.refresh()["path"] == "published"
    svc._db.detach_wal()
    # tamper: the manifest promises a fingerprint the tables can't produce
    mpath = os.path.join(str(tmp_path), "MANIFEST.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["graph_digests"]["social"] = "0" * 16
    with open(mpath, "w") as f:
        f.write(json.dumps(manifest))
    with pytest.raises(RecoveryError, match="verification failed"):
        GraphService(Database(), compiled=False, durable_dir=str(tmp_path),
                     device="cpu")


def test_refresh_failure_contained_and_backoff_then_recovers(tmp_path):
    svc = _durable_service(tmp_path)
    served = svc.extract("social")["fingerprint"]
    _grow_follows(svc, n=2, seed=5)
    rule = FaultRule(site="snapshot.publish", action="raise", times=1)
    with faults.inject(rule):
        out = svc.refresh()
    assert rule.fired == 1
    assert out["path"] == "failed" and out["retryable"]
    assert out["epoch"] == 0                        # old epoch still current
    health = svc.healthz()
    assert health["status"] == "degraded"
    assert "refresh failed" in health["degraded"]["cause"]
    # epoch 0 keeps serving bit-identically while degraded
    assert svc.extract("social")["fingerprint"] == served
    # inside the backoff window the next refresh doesn't even try
    out2 = svc.refresh()
    if out2["path"] == "backoff":
        assert out2["retry_in_s"] > 0
    # after the window, the build succeeds and degradation clears
    out3 = _refresh_until_published(svc)
    assert out3["path"] == "published"
    assert svc.healthz()["status"] == "ok"
    assert svc.extract("social")["fingerprint"] != served
    svc.close()


def test_refresh_midflight_fault_discards_the_side_build(tmp_path):
    svc = _durable_service(tmp_path)
    served = svc.extract("social")["fingerprint"]
    _grow_follows(svc, n=2, seed=5)
    rule = FaultRule(site="refresh.midflight", action="raise", times=1)
    with faults.inject(rule):
        out = svc.refresh()
    assert rule.fired == 1
    assert out["path"] == "failed" and out["epoch"] == 0
    assert svc._store.epochs() == [0]
    assert svc.extract("social")["fingerprint"] == served
    assert _refresh_until_published(svc)["path"] == "published"
    svc.close()


def test_mutate_succeeds_after_transient_wal_fault(tmp_path):
    svc = _durable_service(tmp_path)
    rule = FaultRule(site="wal.append", action="raise", times=1)
    with faults.inject(rule):
        out = _grow_follows(svc, n=2, seed=5)
    assert rule.fired == 1                    # the fault really happened
    assert out["live_epoch"] == 1             # ...and the retry committed
    assert svc.refresh()["path"] == "published"
    svc.close()


def test_persist_failure_contained_publish_stands(tmp_path):
    svc = _durable_service(tmp_path)
    _grow_follows(svc, n=2, seed=5)
    rule = FaultRule(site="wal.rename", action="raise", times=1)
    with faults.inject(rule):
        out = svc.refresh()                   # publish OK; persist's rotate
    assert out["path"] == "published"         # trips the rename fault
    assert rule.fired == 1
    assert "error" in out["persist"]
    assert svc.healthz()["status"] == "degraded"
    assert svc.extract("social")["epoch"] == out["epoch"]
    # next publish re-checkpoints and clears the degradation
    _grow_follows(svc, n=1, seed=6)
    out2 = svc.refresh()
    assert out2["path"] == "published" and "error" not in out2["persist"]
    assert svc.healthz()["status"] == "ok"
    svc.close()


SITES = ("wal.append", "wal.fsync", "wal.rename", "snapshot.publish",
         "scheduler.worker", "refresh.midflight", "engine.cache_fill")
OPS = ("extract", "analyze", "refresh", "mutate")


def _run_op(svc, op, seed) -> str:
    """One serving operation under an armed fault; classify the outcome."""
    try:
        if op == "extract":
            svc.extract("social", timeout=30)
        elif op == "analyze":
            svc.analyze("social", algorithm="degree_stats", timeout=30)
        elif op == "mutate":
            _grow_follows(svc, n=1, seed=seed)
        elif op == "refresh":
            out = svc.refresh()
            if out["path"] in ("failed", "backoff"):
                return "degraded"
            if "error" in (out.get("persist") or {}):
                return "degraded"
        return "ok"
    except RetryableError:
        return "structured-retryable"


@pytest.mark.parametrize("site", SITES)
def test_fault_matrix_site_never_wedges(tmp_path, site):
    svc = _durable_service(tmp_path, max_workers=2)
    svc.extract("social")                     # warm: epoch 0 serves
    outcomes, fired = {}, 0
    for i, op in enumerate(OPS):
        _grow_follows(svc, n=1, seed=100 + i)     # fresh work per op
        rule = FaultRule(site=site, action="raise", times=1)
        with faults.inject(rule):
            outcomes[op] = _run_op(svc, op, seed=200 + i)
        fired += rule.fired
        assert outcomes[op] in ("ok", "degraded", "structured-retryable")
        if outcomes[op] == "degraded":
            assert svc.healthz()["status"] == "degraded"
    assert fired > 0, f"site {site} never fired"

    # faults gone: the service must be fully functional, not wedged
    _grow_follows(svc, n=1, seed=999)
    assert _refresh_until_published(svc)["path"] in ("published", "noop")
    final = svc.extract("social", timeout=30)
    assert final["fingerprint"]
    assert svc.healthz()["status"] == "ok"
    # no leaked pins, no stuck queue entries, every future resolved
    sched = svc._scheduler.stats()
    assert sched["pending"] == 0 and sched["inflight"] == 0
    assert svc._store.pinned_epochs() == []
    for tstats in svc._quotas.stats().values():
        assert tstats.get("inflight", 0) == 0
    svc.close()
    # terminal: a post-close request that must reach the scheduler (a key
    # never tenant-cached) fails fast and structured
    with pytest.raises(ServiceClosed):
        svc.analyze("social", algorithm="pagerank", iterations=2)


def test_fault_matrix_fatal_worker_fault_is_surfaced_not_retried(tmp_path):
    svc = _durable_service(tmp_path)
    with faults.inject(FaultRule(site="scheduler.worker",
                                 action="raise_fatal", times=1)):
        with pytest.raises(FatalFaultInjected):
            svc.extract("social", timeout=30)
    # the key is released: the next identical request recomputes fine
    assert svc.extract("social", timeout=30)["fingerprint"]
    assert svc._store.pinned_epochs() == []
    svc.close()


# ---------------------------------------------------------------------------
# one durable directory, two packages
# ---------------------------------------------------------------------------

def _publish_then_tail(svc):
    """Extract, publish one batch (manifest at P), append an unpublished
    tail, abandon the WAL; returns the fingerprint published at P."""
    svc.extract("social")
    _grow_follows(svc, n=3, seed=5)
    assert svc.refresh()["path"] == "published"
    published = svc.extract("social")["fingerprint"]
    _grow_follows(svc, n=2, seed=6)
    svc._db.detach_wal()                        # simulate SIGKILL
    return published


def _live_fingerprint(db, engine_cls, model):
    return engine_cls(db.snapshot(), compiled=False).extract(
        model).graph.fingerprint()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_durable_dir_recovered_by_the_other_package(tmp_path, writer):
    """A durable_dir written by one package's service is recovered by the
    other's: the published fingerprint at P, then after one refresh the
    WAL tail's, equal to the writer's live database."""
    if writer == "jax":
        model = _follows_model(model_cls=jmodel.GraphModel)
        svc = jserving.GraphService(make_social_jax(), {"social": model},
                                    compiled=False, durable_dir=str(tmp_path))
        engine_cls = japi.ExtractionEngine
    else:
        model = _follows_model()
        svc = _durable_service(tmp_path)
        engine_cls = ExtractionEngine
    published = _publish_then_tail(svc)
    live = _live_fingerprint(svc._db, engine_cls, model)

    if writer == "jax":
        rec = GraphService(Database(), compiled=False,
                           durable_dir=str(tmp_path), device="cpu")
    else:
        rec = jserving.GraphService(jdbm.Database(), compiled=False,
                                    durable_dir=str(tmp_path))
    try:
        assert rec.recovery.path == "checkpoint"
        assert rec.recovery.verified["social"] == published
        assert "social" in rec.models()
        assert rec.extract("social")["fingerprint"] == published
        assert rec.healthz()["recovery"]["replayed_records"] == 1
        assert rec.refresh()["path"] == "published"
        assert rec.extract("social")["fingerprint"] == live
    finally:
        rec.close()


def test_mutate_delete_where_outside_int32_matches_jax(tmp_path):
    """``GraphService.mutate`` with a ``delete_where`` whose value is a
    Python int outside int32 (``POST /v1/mutate`` passes it through)
    deletes what JAX's service deletes, nothing here, where the port used
    to wrap the int and delete rows; the live tables and the WAL's records
    (kind, epoch, counts, payload) equal the JAX service's."""
    from repro_torch.durability import wal as twal
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jsvc = _jservice(durable_dir=str(jdir))
    tsvc = _durable_service(tdir)
    try:
        for where in (("src_sk", ">", 2**40), ("src_sk", "==", 2**32 + 2),
                      ("dst_sk", "<", -2**40)):
            jout = jsvc.mutate("follows", delete_where=where)
            tout = tsvc.mutate("follows", delete_where=where)
            assert tout == jout
        for name, jt in jsvc._db.tables.items():
            tt = tsvc._db.tables[name]
            np.testing.assert_array_equal(_np(tt.valid), _np(jt.valid))
            assert int(tt.valid.sum()) == int(np.asarray(jt.valid).sum())
        jrecs, _ = jdur.wal.read_all(jsvc._db.wal.path)
        trecs, _ = twal.read_all(tsvc._db.wal.path)
        assert len(trecs) == len(jrecs)
        for t, j in zip(trecs, jrecs):
            assert (t.table, t.kind, t.epoch, t.plus_count, t.minus_count) \
                == (j.table, j.kind, j.epoch, j.plus_count, j.minus_count)
            assert t.payload.keys() == j.payload.keys()
            for key, arr in j.payload.items():
                np.testing.assert_array_equal(t.payload[key], arr)
    finally:
        tsvc.close()
        jsvc.close()
