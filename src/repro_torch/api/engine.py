"""Session-based extraction engine with cross-request plan & view caching.

The paper shares join work *within* one extraction (JS-OJ merges sibling
queries, JS-MV materializes common sub-patterns).  A long-lived
:class:`ExtractionEngine` extends that sharing *across* requests:

* **Plan cache** — keyed by the alias-independent signature of every edge
  query in the model plus a fingerprint of the database's ANALYZE stats.
  A repeated model skips Algorithm 2 entirely.
* **View cache** — JS-MV views built for one request are kept (content-
  addressed by their canonical pattern signature) and registered into later
  requests, where the planner treats them as zero-cost MV candidates and
  execution skips their materialization.  Views are invalidated by stats
  fingerprint when ``db.analyze()`` observes a changed base table.

Every request runs against ``db.snapshot()``, so views and re-analyzed
stats never leak into the caller's database.  Everything runs where the
database's tensors live.

Not in this package yet: incremental maintenance (``refresh`` and
``auto_refresh``), EXPLAIN, engine forks, graph analytics, schema discovery
and the baseline methods.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core.database import Database, Fingerprint, TableStats
from repro_torch.core.extract import (
    ExtractedGraph,
    PLANNED_METHODS,
    Timings,
    extract_vertices,
    plan_queries,
    run_plan,
    synchronize_tables,
)
from repro_torch.core.jsmv import ViewDef
from repro_torch.core.model import (
    GraphModel,
    model_signature,
    model_tables,
)
from repro_torch.core.pipeline import PipelineCompiler
from repro_torch.core.planner import ExtractionPlan
from repro_torch.core.shared import SharedPattern
from repro_torch.relational import Table

_NO_REFRESH = ("auto_refresh needs incremental maintenance "
               "(repro_torch.incremental), which is not ported yet")


@dataclasses.dataclass(frozen=True)
class PlanProvenance:
    """Where this request's plan and views came from."""

    method: str
    plan_cache_hit: bool = False
    views_built: Tuple[str, ...] = ()
    views_reused: Tuple[str, ...] = ()


@dataclasses.dataclass
class ExtractionResult:
    """Graph + timings + plan provenance for one ``engine.extract()``."""

    graph: ExtractedGraph
    timings: Timings
    provenance: PlanProvenance
    plan: Optional[ExtractionPlan] = None
    model: Optional[GraphModel] = None

    @property
    def vertices(self) -> Dict[str, Table]:
        return self.graph.vertices

    @property
    def edges(self) -> Dict[str, Table]:
        return self.graph.edges


class _LRUCache:
    """Access-ordered LRU map with hit/miss/eviction counters.

    Eviction order is access time, not insertion time: :meth:`get` moves
    the key to the MRU end, so an entry kept hot by lookups survives
    pressure from a stream of cold inserts.  Not internally locked — the
    owning engine serializes access under its request lock.

    When a ``sizer`` is provided, every entry's device-resident byte size
    (tensor metadata, never a transfer) is tracked in ``bytes`` and
    mirrored to the ``engine_cache_bytes{cache}`` gauge; an optional
    ``max_bytes`` budget evicts LRU-first until under budget — but always
    keeps at least one entry, so a single value larger than the whole
    budget is still cached rather than thrashing forever.
    """

    def __init__(self, capacity: int, name: Optional[str] = None,
                 sizer=None, max_bytes: Optional[int] = None):
        self.capacity = int(capacity)
        self.name = name
        self.sizer = sizer
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._sizes: Dict = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.byte_evictions = 0

    def _event(self, event: str, amount: int = 1) -> None:
        """Per-instance counters stay exact for :meth:`info`; named caches
        additionally flow into the process-wide registry."""
        setattr(self, event, getattr(self, event) + amount)
        if self.name is not None:
            obs.REGISTRY.counter(
                "engine_cache_events_total",
                help="Engine LRU cache hits/misses/evictions by cache.",
                cache=self.name, event=event).inc(amount)

    def _entry_size(self, value) -> int:
        if self.sizer is None:
            return 0
        return int(self.sizer(value))

    def _set_bytes_gauge(self) -> None:
        if self.name is not None and self.sizer is not None:
            obs.REGISTRY.gauge(
                "engine_cache_bytes",
                help="Resident device bytes per engine cache "
                     "(sized from tensor metadata).",
                cache=self.name).set(float(self.bytes))

    def _account(self, key, value) -> None:
        old = self._sizes.pop(key, 0)
        size = self._entry_size(value)
        self._sizes[key] = size
        self.bytes += size - old

    def _evict_lru(self, byte_budget: bool = False) -> None:
        key, _ = self._data.popitem(last=False)
        self.bytes -= self._sizes.pop(key, 0)
        self._event("evictions")
        if byte_budget:
            self.byte_evictions += 1

    def _enforce_budgets(self) -> None:
        while len(self._data) > self.capacity:
            self._evict_lru()
        if self.max_bytes is not None:
            while self.bytes > self.max_bytes and len(self._data) > 1:
                self._evict_lru(byte_budget=True)
        self._set_bytes_gauge()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key, default=None, count: bool = True):
        """Counted, LRU-touching lookup (``count=False`` for bookkeeping
        scans that should not skew the hit-rate counters)."""
        if key in self._data:
            self._data.move_to_end(key)
            if count:
                self._event("hits")
            return self._data[key]
        if count:
            self._event("misses")
        return default

    def put(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        self._account(key, value)
        self._enforce_budgets()

    def pop(self, key, default=None):
        if key in self._data:
            self.bytes -= self._sizes.pop(key, 0)
            value = self._data.pop(key)
            self._set_bytes_gauge()
            return value
        return default

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def keys(self):
        return self._data.keys()

    def clear(self) -> None:
        self._data.clear()
        self._sizes.clear()
        self.bytes = 0
        self._set_bytes_gauge()

    def info(self) -> Dict[str, int]:
        out = {"size": len(self._data), "capacity": self.capacity,
               "hits": self.hits, "misses": self.misses,
               "evictions": self.evictions}
        if self.sizer is not None:    # unsized caches report no byte fields
            out["bytes"] = self.bytes
            out["byte_evictions"] = self.byte_evictions
            if self.max_bytes is not None:
                out["max_bytes"] = self.max_bytes
        return out


@dataclasses.dataclass(frozen=True)
class _CachedView:
    name: str
    pattern: SharedPattern
    table: Table
    stats: TableStats
    base_fingerprints: Dict[str, Fingerprint]  # base table -> stats digest
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class _CachedExtraction:
    """Last materialized result of one (model, method): the state a later
    incremental refresh starts from.  ``base_tables`` / ``base_stats`` pin
    the query-relation tables as of ``epoch`` (shared tensors)."""

    model: GraphModel
    method: str
    plan: Optional[ExtractionPlan]
    graph: ExtractedGraph
    epoch: int
    base_tables: Dict[str, Table]
    base_stats: Dict[str, TableStats]
    plan_key: Optional[Tuple] = None   # where `plan` sits in the plan LRU


class ExtractionEngine:
    """Long-lived extraction session over one :class:`Database`.

    ::

        engine = ExtractionEngine(db)
        result = engine.extract(model)          # cold: plans + builds views
        result = engine.extract(model)          # warm: plan hit, views reused
        result.provenance.plan_cache_hit        # True
        result.provenance.views_reused          # ("view_ab12cd34ef", ...)

    The engine never mutates ``db``; call ``db.analyze(table)`` after
    changing a base table and dependent cached state is discarded on the
    next request.

    The caches are LRU-bounded (``max_plans`` / ``max_views`` /
    ``max_results``) so a long-lived session serving many distinct models
    cannot grow without bound — cached views pin whole materialized join
    results.

    Plan execution runs through a :class:`repro_torch.core.pipeline
    .PipelineCompiler` by default: each plan unit runs as one pre-sized
    unit function (capacities from the cost model, overflow detected
    on-device, one host sync per unit), cached by (unit signature,
    capacity-bucket vector, input-schema fingerprint).  On a CUDA database
    the compiler the engine creates uses the CUDA kernels.  Pass a shared
    ``compiler`` to carry its caches across engines, or ``compiled=False``
    for the eager two-phase reference path.
    """

    def __init__(self, db: Database, max_plans: int = 128,
                 max_views: int = 32,
                 compiler: Optional[PipelineCompiler] = None,
                 compiled: bool = True,
                 auto_refresh: bool = False,
                 max_results: int = 16,
                 cache_byte_budgets: Optional[Dict[str, int]] = None):
        if auto_refresh:
            raise NotImplementedError(_NO_REFRESH)
        self.db = db
        self.max_plans = max_plans
        self.max_views = max_views
        self.max_results = max_results
        self.compiled = bool(compiled)
        self.auto_refresh = False
        self._owns_compiler = compiler is None
        self.compiler = compiler if compiler is not None \
            else PipelineCompiler(device=db.device)
        # one reentrant lock serializes every cache-touching request
        self._lock = threading.RLock()
        # every named cache accounts its device-resident bytes via
        # obs.entry_nbytes (tensor metadata — no transfers); an optional
        # per-cache byte budget ({"results": 64 << 20, ...}) turns the
        # accounting into LRU byte-pressure eviction
        budgets = dict(cache_byte_budgets or {})
        self.cache_byte_budgets = budgets

        def _cache(capacity: int, name: str) -> "_LRUCache":
            return _LRUCache(capacity, name=name, sizer=obs.entry_nbytes,
                             max_bytes=budgets.get(name))

        self._plans: "_LRUCache" = _cache(max_plans, "plans")
        self._views: "_LRUCache" = _cache(max_views, "views")
        # last materialized result per (model signature, method)
        self._results: "_LRUCache" = _cache(max_results, "results")
        # request counters (cache_info "requests")
        self.request_stats: Dict[str, int] = collections.defaultdict(int)

    def _count_request(self, path: str) -> None:
        self.request_stats[path] += 1
        obs.REGISTRY.counter(
            "engine_requests_total",
            help="Executed engine requests by public path.",
            path=path).inc()

    # -- cache bookkeeping ---------------------------------------------------
    def clear(self) -> None:
        """Drop this engine's caches.

        A compiler the engine created is cleared with it; an explicitly
        shared compiler is left alone — its programs and proven capacities
        belong to every engine holding it.
        """
        with self._lock:
            self._plans.clear()
            self._views.clear()
            self._results.clear()
            if self._owns_compiler:
                self.compiler.clear()

    def cache_info(self) -> Dict[str, object]:
        """Cache sizes plus compiled-pipeline hit/miss counters.

        ``executables`` counts the process-wide unit store;
        ``executable_hits`` / ``executable_misses`` / ``pipeline_retries``
        are this engine's compiler's counters (hits mean a unit ran without
        being built again).  ``epoch`` is the database epoch this engine
        serves.  ``caches`` breaks each LRU down into
        size/capacity/hits/misses/evictions/bytes and ``requests`` counts
        executed work per public path.  ``cache_bytes`` totals each cache's
        device-resident bytes (from tensor metadata), and ``device_memory``
        samples the CUDA allocator's live/peak/limit watermarks (``{}`` on
        the CPU).
        """
        with self._lock:
            cstats = self.compiler.cache_info()
            return {"plans": len(self._plans), "views": len(self._views),
                    "results": len(self._results),
                    "epoch": int(self.db.epoch),
                    "executables": int(cstats["executables"]),
                    "executable_hits": int(cstats["hits"]),
                    "executable_misses": int(cstats["misses"]),
                    "pipeline_retries": int(cstats["retries"]),
                    "caches": {"plans": self._plans.info(),
                               "views": self._views.info(),
                               "results": self._results.info()},
                    "cache_bytes": {"plans": self._plans.bytes,
                                    "views": self._views.bytes,
                                    "results": self._results.bytes},
                    "device_memory": obs.device_memory_stats(),
                    "requests": dict(self.request_stats)}

    def _table_fingerprint(self, table: str) -> Optional[Fingerprint]:
        st = self.db.stats.get(table)
        return None if st is None else st.fingerprint()

    def _view_bases_mutated(self, cv: _CachedView) -> bool:
        """Exact staleness signal: any base-table mutation since cv.epoch."""
        return any(
            not self.db.covers_epoch(t, cv.epoch)
            or bool(self.db.deltas_since(t, cv.epoch))
            for t in cv.base_fingerprints)

    def _evict_stale_views(self) -> List[str]:
        """Drop cached views whose base tables changed (or vanished)."""
        evicted = []
        for sig, cv in list(self._views.items()):
            stale = any(self._table_fingerprint(t) != fp
                        for t, fp in cv.base_fingerprints.items())
            if stale or self._view_bases_mutated(cv):
                self._views.pop(sig)
                evicted.append(cv.name)
        return evicted

    def _request_db(self) -> Database:
        """Per-request snapshot with every live cached view registered."""
        rdb = self.db.snapshot()
        for cv in self._views.values():
            rdb.add_view(cv.name, cv.table, cv.stats)
        return rdb

    def _harvest_views(self, rdb: Database, plan: ExtractionPlan,
                       built: List[str], reused: List[str]) -> None:
        """Pull freshly materialized views out of the request db into cache."""
        built_set, reused_set = set(built), set(reused)
        for v in list(plan.reused) + list(plan.views):
            if v.name in reused_set and v.pattern.signature in self._views:
                self._views.get(v.pattern.signature)  # LRU touch + hit
                continue
            if v.name not in built_set:
                continue
            bases = {r.table for r in v.pattern.relations}
            self._views.put(v.pattern.signature, _CachedView(
                name=v.name,
                pattern=v.pattern,
                table=rdb.tables[v.name],
                stats=rdb.stats[v.name],
                base_fingerprints={
                    t: self._table_fingerprint(t) for t in bases
                },
                epoch=self.db.epoch,
            ))

    # -- extraction ----------------------------------------------------------
    def _plan_key(self, model: GraphModel, method: str) -> Tuple:
        """Plan-cache key: model signature + stats digest of *its* tables.

        Fingerprinting only the tables the model reads (not the whole
        catalog) means churn in unrelated tables cannot evict this model's
        plan.
        """
        return (model_signature(model),
                self.db.fingerprint(model_tables(model)), method)

    def _query_base_state(self, model: GraphModel
                          ) -> Tuple[Dict[str, Table], Dict[str, TableStats]]:
        """Current query-relation tables + stats (the next ``old`` side)."""
        names = {r.table for q in model.queries() for r in q.relations}
        return ({t: self.db.tables[t] for t in names},
                {t: self.db.stats[t] for t in names})

    def _remember_result(self, model: GraphModel, method: str,
                         plan: Optional[ExtractionPlan],
                         graph: ExtractedGraph, epoch: int) -> None:
        tables, stats = self._query_base_state(model)
        key = (model_signature(model), method)
        self._results.put(key, _CachedExtraction(
            model=model, method=method, plan=plan, graph=graph,
            epoch=epoch, base_tables=tables, base_stats=stats,
            plan_key=self._plan_key(model, method)))

    def extract(self, model: GraphModel, method: str = "extgraph",
                verbose: bool = False,
                auto_refresh: Optional[bool] = None) -> ExtractionResult:
        """Extract ``model`` with one of the planned methods.

        ``auto_refresh=True`` (maintain a cached result instead of
        re-extracting) needs the incremental layer and raises
        ``NotImplementedError``.
        """
        if auto_refresh:
            raise NotImplementedError(_NO_REFRESH)
        with self._lock:
            self._count_request("extracts")
            with obs.span("engine.extract", model=model.name, method=method):
                return self._extract_full(model, method, verbose)

    def _extract_full(self, model: GraphModel, method: str,
                      verbose: bool = False) -> ExtractionResult:
        if method not in PLANNED_METHODS:
            raise ValueError(
                f"method {method!r} is not one of the planned methods "
                f"{PLANNED_METHODS} (the baselines are not ported yet)")
        queries = model.queries()
        timings = Timings()
        epoch0 = self.db.epoch
        self._count_request("full_extracts")

        t0 = time.perf_counter()
        with obs.span("plan", category="plan") as plan_sp:
            self._evict_stale_views()
            rdb = self._request_db()
            key = self._plan_key(model, method)
            plan = self._plans.get(key, count=False)
            if plan is not None and not all(
                    v.pattern.signature in self._views
                    for v in plan.reused):
                self._plans.pop(key)
                plan = None  # a reused view was LRU-evicted: replan
            hit = plan is not None
            if hit:
                self._plans._event("hits")
            else:
                self._plans._event("misses")
                cached = [ViewDef(cv.name, cv.pattern)
                          for cv in self._views.values()]
                plan = plan_queries(rdb, queries, method,
                                    verbose=verbose, cached_views=cached)
                self._plans.put(key, plan)
            plan_sp.set(cache_hit=hit)
        timings.plan_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        with obs.span("execute", category="execute"):
            edges, built, reused = run_plan(
                rdb, plan,
                compiler=self.compiler if self.compiled else None)
            synchronize_tables(edges.values())
        timings.extract_s = time.perf_counter() - t0
        self._harvest_views(rdb, plan, built, reused)
        provenance = PlanProvenance(
            method=method, plan_cache_hit=hit,
            views_built=tuple(built), views_reused=tuple(reused))

        with obs.span("vertices", category="execute"):
            vertices = extract_vertices(self.db, model)
            graph = ExtractedGraph(vertices=vertices, edges=edges)
            graph.block_until_ready()
        self._remember_result(model, method, plan, graph, epoch0)
        return ExtractionResult(graph=graph, timings=timings,
                                provenance=provenance, plan=plan,
                                model=model)
