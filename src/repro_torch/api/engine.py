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

**Incremental maintenance** — when the database mutates through its
change-capture API (``insert_rows`` / ``delete_rows`` / ``apply_delta``),
:meth:`ExtractionEngine.refresh` brings cached state forward by
*propagating deltas* instead of re-extracting: each edge query is
differentiated by the IVM join rule (:mod:`repro_torch.incremental.delta`),
every term running through the same unit functions (and, on the card, the
same join kernels) as a cold extract; JS-MV views are patched in place,
and a cached CSR is patched via
:meth:`repro_torch.graph.CSRGraph.apply_edge_delta`.  Above a churn
threshold (or when the changelog no longer covers the cached epoch) it
falls back to the full path.  ``auto_refresh=True`` routes every
``extract()`` / ``analyze()`` through this decision, and the returned
:class:`RefreshProvenance` reports which path ran.

**EXPLAIN** — :meth:`ExtractionEngine.explain` reports the plan (join
orders, MV-vs-OJ decision with its cost numbers, capacity buckets, unit
cache state) without executing; :meth:`ExtractionEngine.explain_analyze`
adds the actual rows per join step that the overflow check already
brought to the host.

**Analytics** — :meth:`ExtractionEngine.analyze` extracts (cache-warm),
converts the graph to a :class:`repro_torch.graph.CSRGraph` through a
content-addressed CSR cache, and runs one of
:data:`repro_torch.graph.ALGORITHMS` over it; on the card the CSR build and
the algorithms run on the ``segment_counts`` / ``edge_spmv`` /
``edge_min_label`` / ``frontier_expand`` CUDA kernels.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover - annotation-only
    from repro_torch.graph import CSRGraph

from repro_torch import obs
from repro_torch.core.database import Database, Fingerprint, TableStats
from repro_torch.durability import faults
from repro_torch.core.extract import (
    BASELINE_METHODS,
    ExtractedGraph,
    PLANNED_METHODS,
    Timings,
    extract_vertices,
    plan_queries,
    run_baseline,
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
from repro_torch.incremental.changelog import MergedDelta, merge_deltas
from repro_torch.incremental.delta import DeltaExecutor, apply_table_delta
from repro_torch.relational import Table, bag_cancel_mask
from repro_torch.relational.table import host


@dataclasses.dataclass(frozen=True)
class PlanProvenance:
    """Where this request's plan and views came from."""

    method: str
    plan_cache_hit: bool = False
    views_built: Tuple[str, ...] = ()
    views_reused: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class RefreshProvenance:
    """Which maintenance path served a ``refresh()`` (or auto-refresh).

    ``path`` is one of ``"cold"`` (no cached extraction — full extract),
    ``"noop"`` (no deltas since the cached epoch — cached tables returned
    as-is), ``"delta"`` (differential propagation), or ``"full"`` (churn
    above threshold, or changelog history pruned/replaced — full
    re-extract).  Bag digests are identical across all four paths.
    """

    path: str
    epoch_from: int = 0
    epoch_to: int = 0
    churn: float = 0.0
    threshold: float = 0.0
    tables_changed: Tuple[str, ...] = ()
    rows_changed: int = 0
    views_maintained: Tuple[str, ...] = ()
    csr_patched: bool = False


@dataclasses.dataclass
class ExtractionResult:
    """Graph + timings + plan provenance for one ``engine.extract()``."""

    graph: ExtractedGraph
    timings: Timings
    provenance: PlanProvenance
    plan: Optional[ExtractionPlan] = None
    model: Optional[GraphModel] = None
    refresh: Optional[RefreshProvenance] = None
    _engine: Optional["ExtractionEngine"] = dataclasses.field(
        default=None, repr=False, compare=False)
    _csr: Optional["CSRGraph"] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def vertices(self) -> Dict[str, Table]:
        return self.graph.vertices

    @property
    def edges(self) -> Dict[str, Table]:
        return self.graph.edges

    def graph_view(self, use_kernel: bool = False) -> "CSRGraph":
        """The extracted graph as a :class:`repro_torch.graph.CSRGraph`.

        Memoized on the result; results produced by an engine additionally
        consult the engine's content-addressed CSR cache, so a warm session
        converts each distinct graph exactly once.
        """
        if self.model is None:
            raise ValueError(
                "graph_view() needs the originating GraphModel; this result "
                "was built without one")
        if self._csr is None:
            if self._engine is not None:
                self._csr, _, _ = self._engine._csr_for(
                    self, use_kernel=use_kernel)
            else:
                from repro_torch.graph import build_csr
                self._csr = build_csr(self.graph, self.model,
                                      use_kernel=use_kernel)
        return self._csr


@dataclasses.dataclass(frozen=True)
class AnalyticsProvenance:
    """Where an ``engine.analyze()`` answer came from."""

    algorithm: str
    extraction: PlanProvenance
    csr_cache_hit: bool = False   # True -> the CSR was NOT rebuilt
    csr_key: str = ""             # content address of the extracted graph


@dataclasses.dataclass
class AnalyticsTimings:
    extract_s: float = 0.0     # full extraction request (plan + exec)
    csr_build_s: float = 0.0   # cache key (content digest) + build on a miss
    analyze_s: float = 0.0     # algorithm loop, ended by a device sync

    @property
    def total_s(self) -> float:
        return self.extract_s + self.csr_build_s + self.analyze_s


@dataclasses.dataclass
class AnalyticsResult:
    """Algorithm output + the extraction it ran over."""

    values: object                 # tensor or dict of tensors (per algorithm)
    csr: "CSRGraph"
    extraction: ExtractionResult
    provenance: AnalyticsProvenance
    timings: AnalyticsTimings


def _synchronize(device: Optional[torch.device]) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_labels(kind: str, unit, orders) -> List[str]:
    """Human labels for a program's capacity buckets, in consumption order.

    Mirrors the capacity layout of ``build_query_program`` /
    ``build_merged_program``: the (shared) chain's join steps first, then —
    for merged units — each branch's inner chain (only when it has more
    than one relation) followed by its one outer-join attachment.
    Indicator-only branches contribute no buckets.
    """
    labels = [f"join {alias}" for alias in orders[0][1:]]
    if kind != "merged":
        return labels
    for bi, b in enumerate(unit.branches):
        if not b.relations:
            continue
        if len(b.relations) > 1:
            labels.extend(f"branch[{b.id}] join {alias}"
                          for alias in orders[1 + bi][1:])
        labels.append(f"outer-join {b.id}")
    return labels


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

    def seed(self, other: "_LRUCache") -> None:
        """Adopt ``other``'s entries (shared immutable values, private
        recency book) — the engine-fork primitive snapshots use."""
        self._data.update(other._data)
        for key in other._data:
            old = self._sizes.pop(key, 0)
            size = other._sizes.get(key)
            if size is None:
                size = self._entry_size(other._data[key])
            self._sizes[key] = size
            self.bytes += size - old
        self._enforce_budgets()

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
    # incremental-maintenance state: the changelog cursor this
    # materialization is valid at, plus the base tables (immutable
    # snapshots) and their stats as of that cursor — the "old" side of the
    # differentiation rule.
    epoch: int = 0
    base_tables: Dict[str, Table] = dataclasses.field(default_factory=dict)
    base_stats: Dict[str, TableStats] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class _CachedExtraction:
    """Last materialized result of one (model, method) — refresh() state.

    ``base_tables`` / ``base_stats`` pin the query-relation tables as of
    ``epoch`` (immutable snapshots, shared tensors): they are the ``old``
    bindings of delta terms, so refresh never has to reconstruct history
    from the changelog.

    Frozen (like :class:`_CachedView`): refresh *replaces* cache entries
    instead of mutating them, so entry objects can be shared by reference
    across forked engines — an older epoch's engine keeps serving its
    original entry while the next epoch's fork advances its own copy.
    """

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
    ``max_csrs`` / ``max_results``) so a long-lived session serving many
    distinct models cannot grow without bound — cached views pin whole
    materialized join results.

    Plan execution runs through a :class:`repro_torch.core.pipeline
    .PipelineCompiler` by default: each plan unit runs as one pre-sized
    unit function (capacities from the cost model, overflow detected
    on-device, one host sync per unit), cached by (unit signature,
    capacity-bucket vector, input-schema fingerprint).  On a CUDA database
    the compiler the engine creates uses the CUDA kernels.  Pass a shared
    ``compiler`` to carry its caches across engines, or ``compiled=False``
    for the eager two-phase reference path.

    ``auto_refresh=True`` serves every planned ``extract`` / ``analyze``
    through :meth:`refresh`; ``refresh_threshold`` is the churn (touched
    rows over live rows of the model's query tables) above which a refresh
    re-extracts in full instead of propagating deltas.
    """

    def __init__(self, db: Database, max_plans: int = 128,
                 max_views: int = 32, max_csrs: int = 16,
                 compiler: Optional[PipelineCompiler] = None,
                 compiled: bool = True,
                 auto_refresh: bool = False,
                 refresh_threshold: float = 0.1,
                 max_results: int = 16,
                 cache_byte_budgets: Optional[Dict[str, int]] = None):
        self.db = db
        self.max_plans = max_plans
        self.max_views = max_views
        self.max_csrs = max_csrs
        self.max_results = max_results
        self.compiled = bool(compiled)
        self.auto_refresh = bool(auto_refresh)
        self.refresh_threshold = float(refresh_threshold)
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
        # CSR conversions, content-addressed by graph fingerprint
        self._csrs: "_LRUCache" = _cache(max_csrs, "csrs")
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
            self._csrs.clear()
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
                    "csrs": len(self._csrs), "results": len(self._results),
                    "epoch": int(self.db.epoch),
                    "executables": int(cstats["executables"]),
                    "executable_hits": int(cstats["hits"]),
                    "executable_misses": int(cstats["misses"]),
                    "pipeline_retries": int(cstats["retries"]),
                    "caches": {"plans": self._plans.info(),
                               "views": self._views.info(),
                               "csrs": self._csrs.info(),
                               "results": self._results.info()},
                    "cache_bytes": {"plans": self._plans.bytes,
                                    "views": self._views.bytes,
                                    "csrs": self._csrs.bytes,
                                    "results": self._results.bytes},
                    "device_memory": obs.device_memory_stats(),
                    "requests": dict(self.request_stats)}

    def fork(self, db: Database) -> "ExtractionEngine":
        """A new engine over ``db`` seeded with this engine's cached state.

        The snapshot primitive: the next epoch is built on a fork over a
        fresh ``db.snapshot()`` while readers keep using this engine.
        Cache *entries* are immutable and shared by reference (plans,
        views, CSRs, remembered results — refresh replaces entries, never
        mutates them); the recency books and counters are private.  The
        compiler (and its unit store) is shared, so the fork starts fully
        warm.  ``refresh()`` on the fork then advances the shared entries
        by delta propagation — the changelog carried by the snapshot still
        covers the seeded epochs.
        """
        with self._lock:
            clone = ExtractionEngine(
                db, max_plans=self.max_plans, max_views=self.max_views,
                max_csrs=self.max_csrs, compiler=self.compiler,
                compiled=self.compiled, auto_refresh=self.auto_refresh,
                refresh_threshold=self.refresh_threshold,
                max_results=self.max_results,
                cache_byte_budgets=self.cache_byte_budgets)
            clone._plans.seed(self._plans)
            clone._views.seed(self._views)
            clone._csrs.seed(self._csrs)
            clone._results.seed(self._results)
            return clone

    def _table_fingerprint(self, table: str) -> Optional[Fingerprint]:
        st = self.db.stats.get(table)
        return None if st is None else st.fingerprint()

    def _view_bases_mutated(self, cv: _CachedView) -> bool:
        """Exact staleness signal: any base-table mutation since cv.epoch.

        The stats fingerprints alone are lossy — incremental stats are
        approximations, and an insert+delete round can net back to an
        identical fingerprint while the content changed — so the
        changelog epoch is consulted too.
        """
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
                base_tables={t: self.db.tables[t] for t in bases},
                base_stats={t: self.db.stats[t] for t in bases},
            ))

    # -- extraction ----------------------------------------------------------
    def _plan_key(self, model: GraphModel, method: str) -> Tuple:
        """Plan-cache key: model signature + stats digest of *its* tables.

        Fingerprinting only the tables the model reads (not the whole
        catalog) means churn in unrelated tables cannot evict this model's
        plan — the over-invalidation the incremental layer exists to
        remove.
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

    def adopt_extraction(self, model: GraphModel, graph: ExtractedGraph,
                         method: str = "extgraph",
                         epoch: Optional[int] = None) -> None:
        """Seed the result cache with an externally produced extraction.

        The recovery path restores checkpointed graphs straight into the
        engine: ``graph`` is adopted as ``model``'s maintained result at
        ``epoch`` (default: the database's current epoch), with the
        current query-relation tables as the delta baseline.  Later
        ``refresh()``/auto-refresh calls maintain it incrementally exactly
        as if this engine had extracted it — no plan is attached, so a
        churn-forced full re-extract replans from scratch.
        """
        if method not in PLANNED_METHODS:
            raise ValueError(
                f"adopt_extraction() supports planned methods only, "
                f"not {method!r}")
        with self._lock:
            tables, stats = self._query_base_state(model)
            key = (model_signature(model), method)
            self._results.put(key, _CachedExtraction(
                model=model, method=method, plan=None, graph=graph,
                epoch=self.db.epoch if epoch is None else int(epoch),
                base_tables=tables, base_stats=stats))

    def extract(self, model: GraphModel, method: str = "extgraph",
                verbose: bool = False,
                auto_refresh: Optional[bool] = None) -> ExtractionResult:
        """Extract ``model``; with auto-refresh, maintain instead of redo.

        ``auto_refresh=None`` follows the engine-level setting.  When it
        resolves true (planned methods only), the request is served by
        :meth:`refresh`: cached results are brought forward by delta
        propagation when churn since their epoch is below the threshold,
        by a full re-extract otherwise — never by a cold plan+views+joins
        pass when a maintained one will do.
        """
        auto = self.auto_refresh if auto_refresh is None else bool(
            auto_refresh)
        with self._lock:
            self._count_request("extracts")
            with obs.span("engine.extract", model=model.name, method=method):
                if auto and method in PLANNED_METHODS:
                    return self._refresh_locked(model, method, verbose)
                return self._extract_full(model, method, verbose)

    def _extract_full(self, model: GraphModel, method: str,
                      verbose: bool = False) -> ExtractionResult:
        if method not in PLANNED_METHODS + BASELINE_METHODS:
            raise ValueError(f"unknown method {method!r}")
        queries = model.queries()
        timings = Timings()
        epoch0 = self.db.epoch
        self._count_request("full_extracts")

        if method in PLANNED_METHODS:
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
                    # fault site before the fill: an injected failure loses
                    # only the cache entry, and a retry rebuilds it
                    faults.fire("engine.cache_fill")
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
        else:
            plan = None
            with obs.span("execute", category="execute", baseline=method):
                edges, ext_s, conv_s = run_baseline(self.db, queries, method)
            timings.extract_s, timings.convert_s = ext_s, conv_s
            provenance = PlanProvenance(method=method)

        with obs.span("vertices", category="execute"):
            vertices = extract_vertices(self.db, model)
            graph = ExtractedGraph(vertices=vertices, edges=edges)
            graph.block_until_ready()
        if method in PLANNED_METHODS:
            self._remember_result(model, method, plan, graph, epoch0)
        return ExtractionResult(graph=graph, timings=timings,
                                provenance=provenance, plan=plan,
                                model=model, _engine=self)

    # -- plan introspection: EXPLAIN / EXPLAIN ANALYZE -----------------------
    def explain(self, model: GraphModel, method: str = "extgraph",
                analyze: bool = False) -> "obs.PlanReport":
        """Why this plan?  A structured :class:`repro_torch.obs.PlanReport`.

        Plain ``explain`` runs *only* the planning block of a request —
        stale-view eviction, plan-cache lookup/validation, Algorithm 2 on
        a miss — and never executes a join, never builds a unit function,
        never touches the device.  The produced plan is cached, so
        EXPLAIN-then-extract is a plan-cache hit.  Per plan unit the
        report carries the chosen join order, the MV-reuse vs. outer-join
        decision with the cost-model numbers behind it (chosen plan vs.
        the no-sharing baseline), the pow-2 capacity buckets with their
        provenance (proven by a prior run vs. freshly estimated), and the
        unit-cache state (:meth:`PipelineCompiler.executable_state`).

        ``analyze=True`` (or :meth:`explain_analyze`) first runs the full
        extract through the normal hot path, then reads back the per-step
        *actual* row counts the pipeline's overflow check already synced
        to the host — reporting estimated-vs-actual rows and capacity
        utilization with **zero added device syncs**.
        """
        if method not in PLANNED_METHODS:
            raise ValueError(
                f"explain() supports planned methods only, not {method!r}")
        with self._lock:
            self._count_request("explains")
            with obs.span("engine.explain", model=model.name, method=method,
                          analyze=bool(analyze)):
                result = None
                if analyze:
                    result = self._extract_full(model, method)
                self._evict_stale_views()
                rdb = self._request_db()
                key = self._plan_key(model, method)
                if result is not None and result.plan is not None:
                    plan = result.plan
                    hit = result.provenance.plan_cache_hit
                else:
                    plan = self._plans.get(key, count=False)
                    hit = plan is not None and all(
                        v.pattern.signature in self._views
                        for v in plan.reused)
                    if not hit:
                        cached = [ViewDef(cv.name, cv.pattern)
                                  for cv in self._views.values()]
                        plan = plan_queries(rdb, model.queries(), method,
                                            cached_views=cached)
                        # cache it: EXPLAIN-then-extract hits the plan cache
                        self._plans.put(key, plan)
                timings = None
                if result is not None:
                    timings = {"plan": result.timings.plan_s,
                               "extract": result.timings.extract_s}
                return self._build_report(model, method, rdb, plan, hit,
                                          analyzed=bool(analyze),
                                          timings=timings)

    def explain_analyze(self, model: GraphModel,
                        method: str = "extgraph") -> "obs.PlanReport":
        """EXPLAIN with execution — estimated vs. actual rows per step.

        Runs the full extract (the normal hot path, including its one
        overflow-check host sync per unit attempt), then attaches the
        host-side actual row counts and capacity utilization.  The
        reporting itself performs no device work.
        """
        return self.explain(model, method=method, analyze=True)

    def _build_report(self, model: GraphModel, method: str, rdb: Database,
                      plan: ExtractionPlan, plan_cache_hit: bool, *,
                      analyzed: bool,
                      timings: Optional[Dict[str, float]]) -> "obs.PlanReport":
        from repro_torch.core.cost import estimate_query, view_cost
        from repro_torch.core.jsoj import estimate_merged
        from repro_torch.core.planner import PlanUnit, _plan_db, plan_cost

        # cost numbers behind the MV/OJ decision: the chosen hybrid plan
        # vs. the no-sharing baseline (every edge query its own unit).
        # _plan_db registers estimated stats for not-yet-materialized
        # views, so cold EXPLAIN can size programs without executing.
        pdb = _plan_db(rdb, tuple(plan.reused) + tuple(plan.views))
        baseline = ExtractionPlan(
            views=(), units=tuple(PlanUnit(single=q)
                                  for q in model.queries()))
        cost_baseline = float(plan_cost(rdb, baseline))
        cost_plan = float(plan_cost(rdb, plan))

        reused_views = tuple(
            {"name": v.name,
             "tables": sorted({r.table for r in v.pattern.relations}),
             "rows_est": float(pdb.stats[v.name].rows)}
            for v in plan.reused)
        views = tuple(
            self._unit_report(
                pdb, rdb, "query", v.as_query(), name=v.name,
                report_kind="view", analyzed=analyzed,
                est_cost=float(view_cost(estimate_query(pdb, v.as_query()))))
            for v in plan.views)
        units = []
        for u in plan.units:
            if u.is_single:
                units.append(self._unit_report(
                    pdb, rdb, "edges", u.single, name=u.single.name,
                    report_kind="edges", analyzed=analyzed,
                    est_cost=float(estimate_query(pdb, u.single).cost)))
            else:
                units.append(self._unit_report(
                    pdb, rdb, "merged", u.group,
                    name="+".join(u.group.member_names()),
                    report_kind="merged", analyzed=analyzed,
                    est_cost=float(estimate_merged(pdb, u.group)[0]),
                    members=u.group.member_names()))
        return obs.PlanReport(
            model=model.name, method=method, epoch=int(self.db.epoch),
            analyzed=analyzed, plan_cache_hit=bool(plan_cache_hit),
            cost_plan=cost_plan, cost_baseline=cost_baseline,
            views=views, reused_views=reused_views, units=tuple(units),
            timings_s=dict(timings or {}))

    def _unit_report(self, pdb: Database, rdb: Database, kind: str, unit, *,
                     name: str, report_kind: str, analyzed: bool,
                     est_cost: float, members=()) -> "obs.UnitReport":
        """One unit's report: program peek + unit-cache probe + actuals.

        ``pdb`` (stats-only shadow with estimated view stats) feeds the
        read-only program resolution; ``rdb`` (real tables incl. cached
        views) feeds the unit-cache probe.  With ``analyzed``, the
        per-step actual rows come from the compiler's host-side retention
        — no device work anywhere in here.
        """
        if self.compiled:
            prog, source = self.compiler.peek_program(pdb, kind, unit)
            state = self.compiler.executable_state(prog, rdb.tables)
            record = (self.compiler.last_rows(prog.signature)
                      if analyzed else None)
        else:
            from repro_torch.core.pipeline import (build_merged_program,
                                                   build_query_program)
            if kind == "merged":
                prog = build_merged_program(pdb, unit)
            else:
                prog = build_query_program(pdb, unit,
                                           edges=(kind == "edges"))
            source, state, record = "estimated", "eager", None
        actual = record["actual"] if record else None
        labels = _step_labels(kind, unit, prog.orders)
        steps = tuple(
            obs.StepReport(
                label=labels[i] if i < len(labels) else f"step {i + 1}",
                capacity=int(cap),
                est_rows=(float(prog.est_rows[i])
                          if i < len(prog.est_rows) else 0.0),
                actual_rows=(int(actual[i])
                             if actual is not None and i < len(actual)
                             else None))
            for i, cap in enumerate(prog.capacities))
        return obs.UnitReport(
            name=name, kind=report_kind, inputs=tuple(prog.inputs),
            join_orders=tuple(tuple(o) for o in prog.orders),
            capacities=tuple(int(c) for c in prog.capacities),
            est_cost=float(est_cost), executable=state,
            capacity_source=source, steps=steps, members=tuple(members))

    # -- incremental maintenance ---------------------------------------------
    def _merged_deltas(self, tables, epoch: int, memo: Optional[Dict] = None
                       ) -> Optional[Dict[str, MergedDelta]]:
        """Non-empty merged deltas per table since ``epoch``.

        ``None`` means the changelog cannot service the cursor (history
        pruned, or a table replaced wholesale) — the caller must take the
        full path.  ``memo`` (keyed by ``(table, epoch)``) lets one
        refresh share the folded deltas between the model's edge queries
        and every maintained view instead of re-concatenating per view.
        """
        merged: Dict[str, MergedDelta] = {}
        for t in tables:
            if not self.db.covers_epoch(t, epoch):
                return None
            key = (t, epoch)
            if memo is not None and key in memo:
                d = memo[key]
            else:
                entries = self.db.deltas_since(t, epoch)
                d = merge_deltas(entries) if entries else None
                if memo is not None:
                    memo[key] = d
            if d is not None and not d.empty:
                merged[t] = d
        return merged

    def _maintain_views(self, memo: Optional[Dict] = None) -> List[str]:
        """Patch every cached view whose base tables mutated; returns names.

        Staleness is decided by the exact changelog signal
        (:meth:`_view_bases_mutated`), never by the lossy stats
        fingerprints alone.  Views whose changelog cursor is no longer
        serviceable are evicted (the planner will rebuild them);
        everything else gets the view query's delta applied to the cached
        materialization, its stats row count corrected, and its
        fingerprints/cursor advanced — so a subsequent request treats it
        as fresh instead of rebuilding.
        """
        maintained: List[str] = []
        for sig, cv in list(self._views.items()):
            view = ViewDef(cv.name, cv.pattern)
            merged = self._merged_deltas(view.base_tables(), cv.epoch,
                                         memo=memo)
            if merged is None:
                self._views.pop(sig)     # history gone: must rebuild
                continue
            table, stats = cv.table, cv.stats
            if merged:
                executor = DeltaExecutor(
                    self.db, cv.base_tables, cv.base_stats, merged,
                    compiler=self.compiler if self.compiled else None)
                plus, minus = executor.query_delta(view.as_query(),
                                                   edges=False)
                table = apply_table_delta(table, plus, minus)
                rows = int(table.valid.sum())
                stats = dataclasses.replace(stats, rows=rows)
                maintained.append(cv.name)
            bases = view.base_tables()
            # replace, never mutate: the old entry object may still be
            # serving an older epoch's forked engine
            self._views.put(sig, dataclasses.replace(
                cv, table=table, stats=stats,
                base_fingerprints={
                    t: self._table_fingerprint(t) for t in bases},
                base_tables={t: self.db.tables[t] for t in bases},
                base_stats={t: self.db.stats[t] for t in bases},
                epoch=self.db.epoch))
        return maintained

    def _patch_csr(self, cached: _CachedExtraction, new_graph: ExtractedGraph,
                   deltas: Dict[str, Tuple[List[Table], List[Table]]],
                   vertex_changed: bool) -> bool:
        """Patch the cached CSR of the old graph onto the new fingerprint.

        Only possible when the vertex set is unchanged (dense numbering
        survives) and the old CSR is still cached; edge deltas are
        remapped to dense indices (on the host, as in the JAX package),
        netted (an edge both inserted and deleted since the cached epoch
        is dropped from both sides), and applied as COO append +
        tombstones.  A label that compacts is
        re-sorted where the CSR lives, its offsets through the
        ``segment_counts`` kernel on the card.  Returns True iff a patched
        CSR now serves the new fingerprint.
        """
        from repro_torch.kernels.ops import resolve_use_kernel

        if vertex_changed or not len(self._csrs):
            return False
        old_fp = cached.graph.fingerprint()
        new_fp = new_graph.fingerprint()
        if old_fp == new_fp or new_fp in self._csrs:
            return False
        csr = self._csrs.get(old_fp, count=False)
        if csr is None:
            return False
        use_kernel = resolve_use_kernel(None, csr.device)
        ids = host(csr.vertex_ids)
        by_label = {e.label: e for e in cached.model.edges}

        def remap(values: np.ndarray, vlabel: str) -> Optional[np.ndarray]:
            lo, hi = csr.vertex_ranges[vlabel]
            seg = ids[lo:hi]
            if len(seg) == 0:
                return None if len(values) else \
                    np.zeros((0,), dtype=np.int32)
            pos = np.searchsorted(seg, values)
            ok = (pos < len(seg))
            ok &= np.where(ok, seg[np.minimum(pos, len(seg) - 1)] == values,
                           False)
            if not ok.all():
                return None
            return (lo + pos).astype(np.int32)

        patches = []
        for e in cached.model.edges:
            name = e.query.name
            plus_parts, minus_parts = deltas.get(name, ([], []))
            sides = []
            for parts in (plus_parts, minus_parts):
                datas = [p.to_numpy() for p in parts]
                src = np.concatenate([d["src"] for d in datas]) if datas \
                    else np.zeros((0,), np.int32)
                dst = np.concatenate([d["dst"] for d in datas]) if datas \
                    else np.zeros((0,), np.int32)
                s = remap(src, by_label[e.label].src_label)
                d = remap(dst, by_label[e.label].dst_label)
                if s is None or d is None:
                    return False  # unmappable endpoint: leave CSR to rebuild
                sides.append((s, d))
            (ps, pd), (ms, md) = sides
            if len(ps) and len(ms):
                # an edge inserted and deleted within the window nets out
                # here: the patch tombstones before it appends, so it
                # would otherwise cancel no live edge and keep the new one
                # (the JAX package does; ROADMAP.md §3)
                keep_p = bag_cancel_mask([ps, pd], np.ones(len(ps), bool),
                                         [ms, md])
                keep_m = bag_cancel_mask([ms, md], np.ones(len(ms), bool),
                                         [ps, pd])
                sides = [(ps[keep_p], pd[keep_p]), (ms[keep_m], md[keep_m])]
            if len(sides[0][0]) or len(sides[1][0]):
                patches.append((name, sides))
        for name, ((ps, pd), (ms, md)) in patches:
            csr = csr.apply_edge_delta(name, add_src=ps, add_dst=pd,
                                       del_src=ms, del_dst=md,
                                       use_kernel=use_kernel)
        self._csrs.put(new_fp, csr)
        return True

    def refresh(self, model: GraphModel, method: str = "extgraph",
                verbose: bool = False) -> ExtractionResult:
        """Bring ``model``'s cached extraction up to date with the database.

        Consults the changelog epoch: no mutations → the cached tables are
        returned as-is; churn at or below ``refresh_threshold`` (touched
        rows / live rows over the model's query tables) → the delta path
        (IVM join rule per edge query, JS-MV views maintained in place,
        CSR cache patched); anything else → the full extract path.  The
        result's bag digests are identical to a from-scratch ``extract()``
        on the mutated database, whichever path ran.
        """
        if method not in PLANNED_METHODS:
            raise ValueError(
                f"refresh() supports planned methods only, not {method!r}")
        with self._lock:
            return self._refresh_locked(model, method, verbose)

    def _refresh_locked(self, model: GraphModel, method: str,
                        verbose: bool) -> ExtractionResult:
        self._count_request("refreshes")
        with obs.span("engine.refresh", model=model.name,
                      method=method) as sp:
            res = self._refresh_inner(model, method, verbose)
        rp = res.refresh
        if rp is not None:
            sp.set(path=rp.path, churn=rp.churn,
                   rows_changed=rp.rows_changed)
            obs.REGISTRY.counter(
                "engine_refresh_total",
                help="refresh() requests by maintenance path taken.",
                path=rp.path).inc()
            if rp.path in ("delta", "full"):
                obs.REGISTRY.histogram(
                    "engine_refresh_churn",
                    help="Touched rows / live rows when deltas existed."
                ).observe(rp.churn)
            if rp.rows_changed:
                obs.REGISTRY.counter(
                    "engine_refresh_rows_changed_total",
                    help="Changelog rows folded into refreshes."
                ).inc(rp.rows_changed)
        return res

    def _refresh_inner(self, model: GraphModel, method: str,
                       verbose: bool) -> ExtractionResult:
        key = (model_signature(model), method)
        cached = self._results.get(key)
        if cached is None:
            res = self._extract_full(model, method, verbose)
            res.refresh = RefreshProvenance(path="cold",
                                            epoch_to=self.db.epoch,
                                            threshold=self.refresh_threshold)
            return res
        epoch_from, epoch_to = cached.epoch, self.db.epoch

        delta_memo: Dict = {}
        merged = self._merged_deltas(model_tables(model), cached.epoch,
                                     memo=delta_memo)
        if merged is None:
            res = self._extract_full(model, method, verbose)
            res.refresh = RefreshProvenance(
                path="full", epoch_from=epoch_from, epoch_to=epoch_to,
                churn=1.0, threshold=self.refresh_threshold)
            return res
        if not merged:
            timings = Timings()
            provenance = PlanProvenance(method=method, plan_cache_hit=True)
            result = ExtractionResult(
                graph=cached.graph, timings=timings, provenance=provenance,
                plan=cached.plan, model=model, _engine=self,
                refresh=RefreshProvenance(
                    path="noop", epoch_from=epoch_from, epoch_to=epoch_to,
                    threshold=self.refresh_threshold))
            if epoch_to != epoch_from:
                self._results.put(key, dataclasses.replace(
                    cached, epoch=epoch_to))
            return result

        # churn: touched rows as a fraction of live rows, over query tables
        query_tables = {r.table for q in model.queries()
                        for r in q.relations}
        rows_changed = sum(d.rows_changed for t, d in merged.items()
                           if t in query_tables)
        base_rows = sum(self.db.stats[t].rows for t in query_tables)
        churn = rows_changed / max(base_rows, 1)
        if churn > self.refresh_threshold:
            res = self._extract_full(model, method, verbose)
            res.refresh = RefreshProvenance(
                path="full", epoch_from=epoch_from, epoch_to=epoch_to,
                churn=churn, threshold=self.refresh_threshold,
                tables_changed=tuple(sorted(merged)),
                rows_changed=rows_changed)
            return res

        t0 = time.perf_counter()
        executor = DeltaExecutor(
            self.db, cached.base_tables, cached.base_stats, merged,
            compiler=self.compiler if self.compiled else None)
        new_edges: Dict[str, Table] = {}
        edge_deltas: Dict[str, Tuple[List[Table], List[Table]]] = {}
        for q in model.queries():
            if any(r.table in merged for r in q.relations):
                plus, minus = executor.query_delta(q, edges=True)
                new_edges[q.name] = apply_table_delta(
                    cached.graph.edges[q.name], plus, minus)
                edge_deltas[q.name] = (plus, minus)
            else:
                new_edges[q.name] = cached.graph.edges[q.name]
        maintained = self._maintain_views(memo=delta_memo)
        vertices = extract_vertices(self.db, model)
        graph = ExtractedGraph(vertices=vertices, edges=new_edges)
        graph.block_until_ready()

        vertex_changed = any(v.table in merged for v in model.vertices)
        csr_patched = bool(self._patch_csr(cached, graph, edge_deltas,
                                           vertex_changed))
        timings = Timings()
        timings.extract_s = time.perf_counter() - t0

        # advance the cached state (a *replacement* entry — the old one may
        # still serve an older epoch's fork) and re-key the plan under the
        # new stats
        plan_key = cached.plan_key
        if cached.plan is not None:
            new_key = self._plan_key(model, method)
            if plan_key is not None and plan_key != new_key:
                self._plans.pop(plan_key, None)  # drop the stale slot
            plan_key = new_key
            self._plans.put(new_key, cached.plan)
        base_tables, base_stats = self._query_base_state(model)
        cached = dataclasses.replace(
            cached, graph=graph, epoch=epoch_to, base_tables=base_tables,
            base_stats=base_stats, plan_key=plan_key)
        self._results.put(key, cached)

        provenance = PlanProvenance(method=method, plan_cache_hit=True)
        return ExtractionResult(
            graph=graph, timings=timings, provenance=provenance,
            plan=cached.plan, model=model, _engine=self,
            refresh=RefreshProvenance(
                path="delta", epoch_from=epoch_from, epoch_to=epoch_to,
                churn=churn, threshold=self.refresh_threshold,
                tables_changed=tuple(sorted(merged)),
                rows_changed=rows_changed,
                views_maintained=tuple(maintained),
                csr_patched=csr_patched))

    # -- analytics -----------------------------------------------------------
    def _csr_for(self, result: ExtractionResult, use_kernel: bool = False
                 ) -> Tuple["CSRGraph", bool, str]:
        """CSR for a result's graph via the content-addressed cache.

        Returns ``(csr, cache_hit, content_key)``; a hit means the graph
        was extracted before (by any model/method that produced identical
        tables) and no rebuild happened.  ``use_kernel`` only selects the
        build path on a miss — the resulting CSR is identical either way,
        so the cache is keyed by content alone.
        """
        from repro_torch.graph import build_csr

        fp = result.graph.fingerprint()
        with self._lock:
            csr = self._csrs.get(fp)
            hit = csr is not None
            if not hit:
                csr = build_csr(result.graph, result.model,
                                use_kernel=bool(use_kernel))
                faults.fire("engine.cache_fill")
                self._csrs.put(fp, csr)
            return csr, hit, fp

    def analyze(self, model: GraphModel, algorithm: str = "pagerank",
                method: str = "extgraph", use_kernel: Optional[bool] = None,
                verbose: bool = False, auto_refresh: Optional[bool] = None,
                **params) -> AnalyticsResult:
        """Extract (cache-warm) and run a graph algorithm in one call.

        ``algorithm`` is a key of :data:`repro_torch.graph.ALGORITHMS`
        (``pagerank`` / ``wcc`` / ``khop`` / ``degree_stats``); extra
        ``params`` are forwarded (e.g. ``iters=``, ``label=``, ``seeds=``).
        ``use_kernel=None`` follows the database's device: the CUDA kernels
        on the card, their plain PyTorch versions on the CPU.  A warm
        engine serves this without re-planning, view re-materialization,
        or CSR rebuild (join execution and the graph content digest still
        run per request, against the snapshot) — see the returned
        provenance and per-phase timings, each of which ends in a device
        sync.  ``auto_refresh`` is as in :meth:`extract`: a maintained
        extraction whose CSR the refresh patched is a CSR cache hit.
        """
        from repro_torch.graph.algorithms import ALGORITHMS
        from repro_torch.kernels.ops import resolve_use_kernel

        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; "
                f"have {sorted(ALGORITHMS)}")
        device = self.db.device
        use_kernel = resolve_use_kernel(use_kernel, device)
        with self._lock:
            self._count_request("analyzes")

        with obs.span("engine.analyze", model=model.name,
                      algorithm=algorithm) as sp:
            t0 = time.perf_counter()
            result = self.extract(model, method=method, verbose=verbose,
                                  auto_refresh=auto_refresh)
            extract_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            with obs.span("csr", category="csr") as csr_sp:
                csr, csr_hit, csr_key = self._csr_for(
                    result, use_kernel=use_kernel)
                result._csr = csr
                _synchronize(device)
                csr_sp.set(cache_hit=csr_hit)
            csr_build_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            with obs.span(f"algorithm:{algorithm}", category="execute"):
                values = ALGORITHMS[algorithm](csr, use_kernel=use_kernel,
                                               **params)
                _synchronize(device)
            analyze_s = time.perf_counter() - t0
            sp.set(csr_cache_hit=csr_hit)

        return AnalyticsResult(
            values=values,
            csr=csr,
            extraction=result,
            provenance=AnalyticsProvenance(
                algorithm=algorithm,
                extraction=result.provenance,
                csr_cache_hit=csr_hit,
                csr_key=csr_key),
            timings=AnalyticsTimings(
                extract_s=extract_s,
                csr_build_s=csr_build_s,
                analyze_s=analyze_s),
        )
