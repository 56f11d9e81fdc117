"""`GraphService`: multi-tenant serving front for :class:`ExtractionEngine`.

Composition of the three serving primitives::

    requests ──► QuotaManager ──► CoalescingScheduler ──► SnapshotStore
                 (per-tenant        (single-flight +         (epoch-pinned
                  admission +        bounded queue)           MVCC reads)
                  response LRU)

* Reads (``extract`` / ``analyze``) resolve an epoch (latest unless the
  caller pins one), coalesce on their work identity, and execute against
  that epoch's immutable snapshot engine.  Responses are JSON-ready dicts
  cached per tenant against that tenant's budget.
* Writes (``mutate``) change-capture into the live database only; served
  epochs never see them until ``refresh()`` builds the next snapshot *off
  to the side* (engine fork + incremental refresh per registered model)
  and publishes it with one atomic swap.  Readers pinned to an older
  epoch keep serving bit-identical results from their snapshot.

The service runs engine work on up to ``max_workers`` threads at once, all
on the current CUDA stream: the kernel wrappers count launches under a
lock and share one Bloom-build scratch per (device, stream), so their
launches queue on the stream one after another.
"""
from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Hashable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.builder import model_from_spec, model_to_spec
from repro_torch.api.engine import ExtractionEngine
from repro_torch.core.database import Database
from repro_torch.core.model import GraphModel, model_signature
from repro_torch.core.pipeline import (
    PipelineCompiler,
    persistent_compilation_cache_dir,
)
from repro_torch.durability import faults, recovery as _recovery
from repro_torch.durability.faults import RetryableError
from repro_torch.durability.recovery import RecoveryError, RecoveryReport
from repro_torch.relational.table import host
from repro_torch.serving.quotas import (
    QuotaExceeded,
    QuotaManager,
    TenantQuota,
)
from repro_torch.serving.scheduler import (
    AdmissionError,
    CoalescingScheduler,
    DeadlineExceeded,
    ServiceClosed,
)
from repro_torch.serving.snapshots import Snapshot, SnapshotStore

log = logging.getLogger("repro_torch.serving")

DEFAULT_TENANT = "public"

ModelRef = Union[str, GraphModel, Dict]


class UnknownModel(KeyError):
    def __init__(self, name: str, available):
        super().__init__(name)
        self.name = name
        self.available = sorted(available)

    def __str__(self) -> str:
        return f"unknown model {self.name!r} (have {self.available})"


def _summarize_values(values) -> Dict[str, object]:
    """JSON-ready summary of algorithm output (array or dict of arrays).

    Tensors are copied to the host first; the summary and the digest are
    over the same dtype and bytes as the JAX package's.
    """
    if isinstance(values, dict):
        return {k: _summarize_values(v) for k, v in values.items()}
    arr = host(values) if isinstance(values, torch.Tensor) \
        else np.asarray(values)
    out: Dict[str, object] = {"shape": list(arr.shape),
                              "dtype": str(arr.dtype)}
    if arr.size:
        out.update(min=float(arr.min()), max=float(arr.max()),
                   mean=float(arr.mean()))
    out["digest"] = hashlib.sha1(
        np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]
    return out


class GraphService:
    """Long-lived multi-tenant serving session over one live database.

    ``models`` maps serving names to :class:`GraphModel`\\ s; requests refer
    to models by name (the HTTP front end only ever sees names).  Passing a
    ``GraphModel`` to :meth:`extract`/:meth:`analyze` registers it under
    its own ``model.name``.

    The live ``db`` belongs to the service: mutate it through
    :meth:`mutate` (or mutate it directly and call :meth:`refresh`) — the
    epoch actually *served* only advances when :meth:`refresh` publishes.

    ``persistent_cache`` is the engine's: the directory where the CUDA
    kernels are built and found (``REPRO_COMPILATION_CACHE`` when None;
    with neither, ``build/kernels/``).  ``device`` is where a recovery from
    ``durable_dir`` restores the tables: ``None`` means ``db``'s device, or
    the CUDA card when ``db`` is empty.
    """

    def __init__(self, db: Database,
                 models: Optional[Dict[str, GraphModel]] = None, *,
                 compiler: Optional[PipelineCompiler] = None,
                 compiled: bool = True,
                 max_workers: int = 4,
                 max_queue: int = 64,
                 default_quota: Optional[TenantQuota] = None,
                 tenant_quotas: Optional[Dict[str, TenantQuota]] = None,
                 keep_snapshots: int = 2,
                 refresh_threshold: float = 0.1,
                 persistent_cache: Optional[str] = None,
                 engine_opts: Optional[Dict[str, int]] = None,
                 durable_dir: Optional[str] = None,
                 retry_attempts: int = 3,
                 device=None):
        self._db_lock = threading.RLock()     # guards live-db mutations
        self._build_lock = threading.Lock()   # one epoch builder at a time
        self._models: Dict[str, GraphModel] = dict(models or {})
        opts = dict(engine_opts or {})
        self._engine_opts = opts
        self._durable_dir = durable_dir
        self._device = device if device is not None else db.device
        self._retry_attempts = max(1, int(retry_attempts))
        self._degraded: Optional[Dict[str, object]] = None
        self._refresh_failures = 0
        self._refresh_retry_at = 0.0
        self.recovery: Optional[RecoveryReport] = None
        if durable_dir is not None:
            db, base_db, base_engine = self._recover(
                db, durable_dir, compiler=compiler, compiled=compiled,
                refresh_threshold=refresh_threshold,
                persistent_cache=persistent_cache)
        else:
            base_db = db.snapshot()
            base_engine = ExtractionEngine(
                base_db, compiler=compiler, compiled=compiled,
                auto_refresh=False, refresh_threshold=refresh_threshold,
                persistent_cache=persistent_cache, **opts)
        self._db = db
        self.compiler = base_engine.compiler
        self._store = SnapshotStore(
            Snapshot(epoch=base_db.epoch, db=base_db, engine=base_engine),
            keep=keep_snapshots)
        self._scheduler = CoalescingScheduler(max_workers=max_workers,
                                              max_queue=max_queue)
        self._quotas = QuotaManager(default=default_quota,
                                    per_tenant=tenant_quotas)
        self.started_at = time.time()

    def _recover(self, base: Database, durable_dir: str, *,
                 compiler, compiled, refresh_threshold, persistent_cache):
        """Warm-restart path: manifest restore → verify → replay → re-arm.

        1. Restore the checkpointed database at the last published epoch P
           (or fall back to the caller's base when nothing was published).
        2. Verify by bag-digest parity: every model recorded in the
           manifest must reproduce its recorded graph fingerprint —
           recomputed over the checkpointed graph tables when present
           (which are then adopted straight into the engine's result
           cache, so the first response needs no extract at all), via a
           fresh extract over the restored tables otherwise.
           :class:`RecoveryError` on any mismatch.
        3. Replay the WAL tail (epochs > P) through the ordinary mutation
           API, repopulating the changelog; only then attach the WAL for
           appending.
        4. Resume serving at P — exactly the epoch the dead process was
           serving.  The replayed tail (P, L] is live-but-unpublished,
           just as it was pre-crash; the next :meth:`refresh` publishes
           it through the ordinary incremental path, cache-warm because
           verification already primed the engine's results at P.
        """
        manifest = _recovery.load_manifest(durable_dir)
        verified: Dict[str, str] = {}
        if manifest is None:
            log.warning(
                "durable_dir %s has no manifest: cold extract over the "
                "base database + full WAL replay", durable_dir)
            db = base
            path, manifest_epoch = "cold", None
            replayed, skipped, truncated = _recovery.replay_wal(
                db, durable_dir, device=self._device)
            snap_db = db.snapshot()
            engine = ExtractionEngine(
                snap_db, compiler=compiler, compiled=compiled,
                auto_refresh=False, refresh_threshold=refresh_threshold,
                persistent_cache=persistent_cache, **self._engine_opts)
        else:
            db = _recovery.restore_database(durable_dir, manifest,
                                            device=self._device)
            path, manifest_epoch = "checkpoint", int(manifest["epoch"])
            for name, spec in dict(manifest.get("models") or {}).items():
                if name not in self._models:
                    self._models[name] = model_from_spec(spec)
            db_at_p = db.snapshot()
            engine = ExtractionEngine(
                db_at_p, compiler=compiler, compiled=compiled,
                auto_refresh=False, refresh_threshold=refresh_threshold,
                persistent_cache=persistent_cache, **self._engine_opts)
            digests = dict(manifest.get("graph_digests") or {})
            graphs = _recovery.load_graphs(durable_dir, manifest,
                                           device=self._device)
            for name in sorted(digests):
                model = self._models.get(name)
                if model is None:
                    continue
                graph = graphs.get(name)
                if graph is not None:
                    fp = graph.fingerprint()
                else:
                    fp = engine.extract(model).graph.fingerprint()
                if fp != digests[name]:
                    raise RecoveryError(
                        f"recovery verification failed for model "
                        f"{name!r}: extracted fingerprint {fp} != "
                        f"manifest digest {digests[name]} at epoch "
                        f"{manifest_epoch}")
                if graph is not None:
                    engine.adopt_extraction(model, graph,
                                            epoch=db_at_p.epoch)
                verified[name] = fp
            replayed, skipped, truncated = _recovery.replay_wal(
                db, durable_dir, device=self._device)
            snap_db = db_at_p
        db.attach_wal(durable_dir)
        obs.failure_counter("durability_recoveries_total", path=path).inc()
        self.recovery = RecoveryReport(
            path=path, manifest_epoch=manifest_epoch,
            live_epoch=db.epoch, replayed_records=replayed,
            skipped_records=skipped, truncated_bytes=truncated,
            verified=verified)
        log.info("recovered %s: %s", durable_dir, self.recovery.summary())
        return db, snap_db, engine

    # -- model registry ------------------------------------------------------
    def register_model(self, name: str, model: GraphModel) -> None:
        self._models[name] = model

    def models(self):
        return sorted(self._models)

    def _resolve_model(self, model: ModelRef) -> Tuple[str, GraphModel]:
        if isinstance(model, GraphModel):
            self._models.setdefault(model.name, model)
            return model.name, model
        if isinstance(model, dict):
            # Inline JSON spec — e.g. a /v1/discover ``model_spec`` posted
            # straight back.  Registered under its own name so later
            # requests can address it by name alone; a name that is already
            # taken by a *different* model gets a signature-suffixed key
            # rather than silently shadowing (or being shadowed by) it.
            built = model_from_spec(model)
            name = built.name
            existing = self._models.get(name)
            if existing is not None and (model_signature(existing)
                                         != model_signature(built)):
                digest = hashlib.sha1(
                    repr(model_signature(built)).encode()).hexdigest()[:8]
                name = f"{name}@{digest}"
            self._models.setdefault(name, built)
            return name, self._models[name]
        m = self._models.get(model)
        if m is None:
            raise UnknownModel(model, self._models)
        return model, m

    # -- write side ----------------------------------------------------------
    def mutate(self, table: str, insert: Optional[Dict] = None,
               delete_mask: Optional[np.ndarray] = None,
               delete_where: Optional[Tuple[str, str, object]] = None
               ) -> Dict[str, object]:
        """Change-capture a mutation into the live database.

        Served snapshots are untouched until :meth:`refresh` publishes the
        next epoch.  Returns the live (unpublished) epoch.

        Each database op is retried individually on
        :class:`RetryableError` (e.g. a transient WAL-append fault):
        WAL-first commit means a failed op left no in-memory state behind,
        so a per-op retry can never double-apply — retrying the *whole*
        mutation could.
        """
        with self._db_lock:
            if delete_mask is not None:
                self._retrying("mutate", lambda: self._db.delete_rows(
                    table, np.asarray(delete_mask)))
            if delete_where is not None:
                col, op, value = delete_where
                self._retrying("mutate", lambda: self._db.delete_where(
                    table, col, op, value))
            if insert:
                cols = {k: np.asarray(v) for k, v in insert.items()}
                self._retrying("mutate", lambda: self._db.insert_rows(
                    table, **cols))
            return {"table": table, "live_epoch": self._db.epoch,
                    "served_epoch": self._store.current_epoch()}

    def _retrying(self, op: str, fn: Callable[[], object]) -> object:
        """Run ``fn``, retrying :class:`RetryableError` with backoff.

        Bounded at ``retry_attempts`` total tries; anything else (including
        :class:`~repro_torch.durability.faults.FatalFaultInjected`) propagates on
        the first throw.
        """
        attempt = 1
        while True:
            try:
                return fn()
            except RetryableError as e:
                if attempt >= self._retry_attempts:
                    raise
                obs.failure_counter("serving_retries_total", op=op).inc()
                delay = max(getattr(e, "retry_after", 0.0) or 0.0,
                            min(0.2, 0.01 * (2 ** (attempt - 1))))
                log.warning("retryable failure in %s (attempt %d/%d): %s",
                            op, attempt, self._retry_attempts, e)
                time.sleep(delay)
                attempt += 1

    def refresh(self) -> Dict[str, object]:
        """Build the next epoch off to the side and publish it atomically.

        The new snapshot's engine is a cache-warm fork of the current one;
        every registered model is brought forward by the engine's
        incremental refresh (delta propagation below the churn threshold,
        full re-extract above it).  Readers pinned to older epochs are
        never blocked and never observe intermediate state.

        Failure containment: a refresh that throws mid-build discards the
        side build entirely — epoch E keeps serving, the service turns
        ``degraded`` (visible in :meth:`healthz`), and the next refresh
        retries after an exponential backoff window (``path="backoff"``
        while the window is open).  A success clears the degraded flag and
        — when a ``durable_dir`` is configured — checkpoints the manifest
        and prunes published WAL segments.
        """
        t0 = time.perf_counter()
        with self._build_lock, obs.span("serve.refresh") as sp:
            now = time.monotonic()
            if self._degraded is not None and now < self._refresh_retry_at:
                remaining = round(self._refresh_retry_at - now, 3)
                sp.set(path="backoff", retry_in_s=remaining)
                return {"path": "backoff",
                        "epoch": self._store.current_epoch(),
                        "cause": self._degraded.get("cause"),
                        "retry_in_s": remaining, "build_s": 0.0}
            try:
                with self._db_lock:
                    new_db = self._db.snapshot()
                with self._store.pin() as cur:
                    if new_db.epoch == cur.epoch:
                        sp.set(path="noop", epoch=cur.epoch)
                        return {"path": "noop", "epoch": cur.epoch,
                                "build_s": 0.0}
                    new_engine = cur.engine.fork(new_db)
                paths: Dict[str, str] = {}
                digests: Dict[str, str] = {}
                graphs: Dict[str, object] = {}
                for name, model in sorted(self._models.items()):
                    res = self._retrying(
                        "refresh", lambda m=model: new_engine.refresh(m))
                    paths[name] = (res.refresh.path if res.refresh
                                   else "cold")
                    digests[name] = res.graph.fingerprint()
                    graphs[name] = res.graph
                faults.fire("refresh.midflight")
                snap = self._store.publish(Snapshot(
                    epoch=new_db.epoch, db=new_db, engine=new_engine))
            except Exception as e:
                self._refresh_failures += 1
                backoff = min(30.0,
                              0.05 * (2 ** (self._refresh_failures - 1)))
                self._refresh_retry_at = time.monotonic() + backoff
                self._degraded = {
                    "cause": f"refresh failed: {e}",
                    "exception": type(e).__name__,
                    "failures": self._refresh_failures,
                    "retry_in_s": backoff,
                }
                obs.failure_counter("serving_refresh_failures_total",
                                    exception=type(e).__name__).inc()
                log.warning("refresh failed (still serving epoch %d): %s",
                            self._store.current_epoch(), e)
                sp.set(path="failed", error=str(e))
                return {"path": "failed", "error": str(e),
                        "retryable": True,
                        "epoch": self._store.current_epoch(),
                        "retry_in_s": backoff,
                        "build_s": round(time.perf_counter() - t0, 4)}
            self._degraded = None
            self._refresh_failures = 0
            self._refresh_retry_at = 0.0
            out = {"path": "published", "epoch": snap.epoch,
                   "models": paths,
                   "build_s": round(time.perf_counter() - t0, 4)}
            persist = self._persist_published(new_db, digests, graphs)
            if persist is not None:
                out["persist"] = persist
            sp.set(path="published", epoch=snap.epoch, models=paths)
            return out

    def _persist_published(self, new_db: Database,
                           digests: Dict[str, str],
                           graphs: Optional[Dict[str, object]] = None
                           ) -> Optional[Dict[str, object]]:
        """Checkpoint the just-published epoch; contained on failure.

        The publish already happened and stands — a persist failure only
        marks the service degraded (the *next* successful refresh writes a
        fresh manifest covering this epoch too) and counts
        ``serving_persist_failures_total``.
        """
        if self._durable_dir is None:
            return None
        try:
            specs: Dict[str, Dict] = {}
            for name, model in sorted(self._models.items()):
                try:
                    specs[name] = model_to_spec(model)
                except Exception:
                    continue    # non-spec-expressible model: recoverable
                                # only if re-registered by the caller
            _recovery.write_manifest(self._durable_dir, new_db, specs,
                                     digests, graphs=graphs)
            pruned = 0
            wal = self._db.wal
            if wal is not None:
                # rotate/prune under the db lock: the WAL is single-writer
                # and mutate() appends under this same lock
                with self._db_lock:
                    wal.rotate()
                    pruned = wal.prune(new_db.epoch)
            return {"manifest_epoch": new_db.epoch,
                    "pruned_segments": pruned}
        except Exception as e:
            obs.failure_counter("serving_persist_failures_total",
                                exception=type(e).__name__).inc()
            self._degraded = {"cause": f"persist failed: {e}",
                              "exception": type(e).__name__,
                              "failures": self._refresh_failures,
                              "retry_in_s": 0.0}
            log.warning("manifest persist failed (epoch %d still "
                        "published): %s", new_db.epoch, e)
            return {"error": str(e)}

    # -- read side -----------------------------------------------------------
    def submit_extract(self, model: ModelRef, method: str = "extgraph",
                       tenant: str = DEFAULT_TENANT,
                       epoch: Optional[int] = None,
                       request_id: Optional[str] = None,
                       deadline_s: Optional[float] = None
                       ) -> Tuple[Future, Dict[str, object]]:
        """Schedule an extract; returns ``(future, request_meta)``.

        Raises :class:`QuotaExceeded` / :class:`AdmissionError` /
        :class:`DeadlineExceeded` at the door (never after work started).
        The future resolves to the shared JSON-ready payload;
        ``request_meta`` carries per-request facts (coalesced / cache
        source / epoch) that are not shared.
        """
        name, m = self._resolve_model(model)
        key = ("extract", name, model_signature(m), method)

        def work(snap: Snapshot) -> Dict[str, object]:
            # auto_refresh: serve the maintained result when one exists —
            # on an immutable snapshot that is a pure cache hit (and it is
            # what lets a recovered epoch serve its adopted checkpoint
            # graph without re-extracting); first requests fall through to
            # the ordinary full extract
            res = snap.engine.extract(m, method=method, auto_refresh=True)
            g = res.graph
            with obs.span("payload", category="transfer"):
                return {
                    "kind": "extract", "model": name, "method": method,
                    "epoch": snap.epoch,
                    "fingerprint": g.fingerprint(),
                    "vertices": {k: int(t.valid.sum())
                                 for k, t in g.vertices.items()},
                    "edges": {k: int(t.valid.sum())
                              for k, t in g.edges.items()},
                    "plan_cache_hit": bool(res.provenance.plan_cache_hit),
                    "views_reused": list(res.provenance.views_reused),
                    "timings_s": {"plan": res.timings.plan_s,
                                  "extract": res.timings.extract_s},
                }

        return self._admit_and_submit(tenant, key, epoch, work,
                                      kind="extract", request_id=request_id,
                                      deadline_s=deadline_s)

    def submit_analyze(self, model: ModelRef, algorithm: str = "pagerank",
                       method: str = "extgraph",
                       tenant: str = DEFAULT_TENANT,
                       epoch: Optional[int] = None,
                       request_id: Optional[str] = None,
                       deadline_s: Optional[float] = None,
                       **params) -> Tuple[Future, Dict[str, object]]:
        """Schedule extract+algorithm; returns ``(future, request_meta)``."""
        name, m = self._resolve_model(model)
        pkey = tuple(sorted((k, repr(v)) for k, v in params.items()))
        key = ("analyze", name, model_signature(m), method, algorithm, pkey)

        def work(snap: Snapshot) -> Dict[str, object]:
            res = snap.engine.analyze(m, algorithm=algorithm, method=method,
                                      **params)
            with obs.span("payload", category="transfer"):
                return {
                    "kind": "analyze", "model": name, "method": method,
                    "algorithm": algorithm, "epoch": snap.epoch,
                    "fingerprint": res.extraction.graph.fingerprint(),
                    "csr_cache_hit": bool(res.provenance.csr_cache_hit),
                    "values": _summarize_values(res.values),
                    "timings_s": {"extract": res.timings.extract_s,
                                  "csr_build": res.timings.csr_build_s,
                                  "analyze": res.timings.analyze_s},
                }

        return self._admit_and_submit(tenant, key, epoch, work,
                                      kind="analyze", request_id=request_id,
                                      deadline_s=deadline_s)

    def submit_explain(self, model: ModelRef, method: str = "extgraph",
                       analyze: bool = False,
                       tenant: str = DEFAULT_TENANT,
                       epoch: Optional[int] = None,
                       request_id: Optional[str] = None,
                       deadline_s: Optional[float] = None
                       ) -> Tuple[Future, Dict[str, object]]:
        """Schedule EXPLAIN (optionally ANALYZE); returns ``(future, meta)``.

        Plain EXPLAIN only plans (no join execution, no device work) but
        still runs through admission/coalescing so concurrent identical
        asks share one report per epoch; ANALYZE executes the full
        extract through the engine's hot path first, and the report's
        actual-row columns come from host-side values the pipeline had
        already synced — zero added device round-trips.
        """
        name, m = self._resolve_model(model)
        key = ("explain", name, model_signature(m), method, bool(analyze))

        def work(snap: Snapshot) -> Dict[str, object]:
            report = snap.engine.explain(m, method=method,
                                         analyze=bool(analyze))
            return {
                "kind": "explain", "model": name, "method": method,
                "analyze": bool(analyze), "epoch": snap.epoch,
                "report": report.to_json(),
                "text": report.render_text(),
            }

        return self._admit_and_submit(tenant, key, epoch, work,
                                      kind="explain", request_id=request_id,
                                      deadline_s=deadline_s)

    def submit_discover(self, tables: Optional[list] = None, *,
                        sample: int = 512, use_name_hints: bool = True,
                        accept_threshold: float = 0.5,
                        top: Optional[int] = None,
                        tenant: str = DEFAULT_TENANT,
                        epoch: Optional[int] = None,
                        request_id: Optional[str] = None,
                        deadline_s: Optional[float] = None
                        ) -> Tuple[Future, Dict[str, object]]:
        """Schedule schema-to-graph discovery; returns ``(future, meta)``.

        Runs :meth:`ExtractionEngine.discover` against the pinned epoch's
        snapshot, so concurrent identical requests coalesce to one pass
        and a published mutation (new epoch) naturally re-keys the work.
        The payload is JSON-ready: accepted FKs, ranked edge candidates
        (``top`` trims the ranking), and a ``model_spec`` the client can
        POST straight back to ``/v1/extract`` after review.
        """
        tkey = tuple(sorted(set(tables))) if tables else None
        key = ("discover", tkey, int(sample), bool(use_name_hints),
               float(accept_threshold), None if top is None else int(top))

        def work(snap: Snapshot) -> Dict[str, object]:
            res = snap.engine.discover(
                list(tkey) if tkey else None, sample=sample,
                use_name_hints=use_name_hints,
                accept_threshold=accept_threshold)
            edges = res.edges if top is None else res.edges[:top]
            return {
                "kind": "discover", "epoch": snap.epoch,
                "tables": list(res.params["tables"]),
                "fks": [{"child": f"{c.child_table}.{c.child_col}",
                         "parent": f"{c.parent_table}.{c.parent_col}",
                         "confidence": round(c.confidence, 4),
                         "containment": [c.matched, c.sampled],
                         "compiled": bool(c.compiled)}
                        for c in res.fks],
                "vertices": [{"label": v.label, "table": v.table,
                              "id_col": v.id_col,
                              "confidence": round(v.confidence, 4)}
                             for v in res.vertices],
                "edges": [e.spec() for e in edges],
                "model_spec": res.model_spec(top=top),
                "stats": dict(res.stats),
                "timings_s": dict(res.timings),
            }

        return self._admit_and_submit(tenant, key, epoch, work,
                                      kind="discover",
                                      request_id=request_id,
                                      deadline_s=deadline_s)

    def extract(self, model: ModelRef, method: str = "extgraph",
                tenant: str = DEFAULT_TENANT, epoch: Optional[int] = None,
                timeout: Optional[float] = None,
                request_id: Optional[str] = None,
                deadline_s: Optional[float] = None) -> Dict[str, object]:
        """Blocking :meth:`submit_extract`; merges per-request meta in."""
        fut, meta = self.submit_extract(model, method=method, tenant=tenant,
                                        epoch=epoch, request_id=request_id,
                                        deadline_s=deadline_s)
        return {**fut.result(timeout), **meta}

    def analyze(self, model: ModelRef, algorithm: str = "pagerank",
                method: str = "extgraph", tenant: str = DEFAULT_TENANT,
                epoch: Optional[int] = None,
                timeout: Optional[float] = None,
                request_id: Optional[str] = None,
                deadline_s: Optional[float] = None,
                **params) -> Dict[str, object]:
        """Blocking :meth:`submit_analyze`; merges per-request meta in."""
        fut, meta = self.submit_analyze(model, algorithm=algorithm,
                                        method=method, tenant=tenant,
                                        epoch=epoch, request_id=request_id,
                                        deadline_s=deadline_s,
                                        **params)
        return {**fut.result(timeout), **meta}

    def explain(self, model: ModelRef, method: str = "extgraph",
                analyze: bool = False, tenant: str = DEFAULT_TENANT,
                epoch: Optional[int] = None,
                timeout: Optional[float] = None,
                request_id: Optional[str] = None,
                deadline_s: Optional[float] = None) -> Dict[str, object]:
        """Blocking :meth:`submit_explain`; merges per-request meta in."""
        fut, meta = self.submit_explain(model, method=method,
                                        analyze=analyze, tenant=tenant,
                                        epoch=epoch, request_id=request_id,
                                        deadline_s=deadline_s)
        return {**fut.result(timeout), **meta}

    def discover(self, tables: Optional[list] = None, *,
                 sample: int = 512, use_name_hints: bool = True,
                 accept_threshold: float = 0.5, top: Optional[int] = None,
                 tenant: str = DEFAULT_TENANT, epoch: Optional[int] = None,
                 timeout: Optional[float] = None,
                 request_id: Optional[str] = None,
                 deadline_s: Optional[float] = None) -> Dict[str, object]:
        """Blocking :meth:`submit_discover`; merges per-request meta in."""
        fut, meta = self.submit_discover(
            tables, sample=sample, use_name_hints=use_name_hints,
            accept_threshold=accept_threshold, top=top, tenant=tenant,
            epoch=epoch, request_id=request_id, deadline_s=deadline_s)
        return {**fut.result(timeout), **meta}

    # -- shared submit plumbing ----------------------------------------------
    @staticmethod
    def _count_serve(kind: str, tenant: str, outcome: str) -> None:
        obs.REGISTRY.counter(
            "serving_requests_total",
            help="Served requests by kind, tenant, and outcome.",
            kind=kind, tenant=tenant, outcome=outcome).inc()

    def _admit_and_submit(self, tenant: str, base_key: Hashable,
                          epoch: Optional[int], work,
                          kind: str = "request",
                          request_id: Optional[str] = None,
                          deadline_s: Optional[float] = None
                          ) -> Tuple[Future, Dict[str, object]]:
        t_submit = time.perf_counter()
        trace_id = obs.sanitize_trace_id(request_id) or obs.new_trace_id()
        try:
            self._quotas.admit(tenant)
        except QuotaExceeded:
            self._count_serve(kind, tenant, "rejected-quota")
            obs.REGISTRY.counter(
                "serving_quota_rejections_total",
                help="Requests rejected at the tenant-quota door.",
                tenant=tenant, reason="inflight").inc()
            raise
        try:
            pin_ctx = self._store.pin(epoch)
            snap = pin_ctx.__enter__()
        except BaseException:
            self._quotas.release(tenant)
            raise
        key = (snap.epoch,) + (base_key if isinstance(base_key, tuple)
                               else (base_key,))
        meta: Dict[str, object] = {"tenant": tenant, "coalesced": False,
                                   "source": "computed",
                                   "trace_id": trace_id}

        cached = self._quotas.cached(tenant, key)
        if cached is not None:
            pin_ctx.__exit__(None, None, None)
            self._quotas.release(tenant)
            fut: Future = Future()
            fut.set_result(cached)
            meta["source"] = "tenant-cache"
            self._count_serve(kind, tenant, "tenant-cache")
            obs.TRACER.record(f"serve.{kind}", t_submit,
                              time.perf_counter(), trace_id=trace_id,
                              parent_id="", tenant=tenant,
                              source="tenant-cache")
            return fut, meta

        def traced_work() -> object:
            # runs on a scheduler worker thread: root the request's trace
            # here, backdated to submit time so queue wait is inside it
            with obs.span(f"serve.{kind}", trace_id=trace_id,
                          start_s=t_submit, tenant=tenant,
                          epoch=snap.epoch) as root:
                obs.TRACER.record("queue.wait", t_submit,
                                  time.perf_counter(), category="queue")
                payload = self._retrying(kind, lambda: work(snap))
                payload["trace_id"] = root.trace_id
                return payload

        try:
            fut, joined = self._scheduler.submit_ex(key, traced_work,
                                                    deadline_s=deadline_s)
        except AdmissionError:
            pin_ctx.__exit__(None, None, None)
            self._quotas.release(tenant)
            self._count_serve(kind, tenant, "rejected-queue")
            raise
        except DeadlineExceeded:
            pin_ctx.__exit__(None, None, None)
            self._quotas.release(tenant)
            self._count_serve(kind, tenant, "rejected-deadline")
            raise
        except ServiceClosed:
            pin_ctx.__exit__(None, None, None)
            self._quotas.release(tenant)
            self._count_serve(kind, tenant, "rejected-closed")
            obs.failure_counter("serving_closed_rejections_total",
                                kind=kind).inc()
            raise
        except BaseException:
            pin_ctx.__exit__(None, None, None)
            self._quotas.release(tenant)
            raise

        if joined:
            # the original submission's pin keeps this epoch alive
            pin_ctx.__exit__(None, None, None)
            meta["coalesced"] = True
            meta["source"] = "coalesced"
            self._count_serve(kind, tenant, "coalesced")
            leader_tid = getattr(fut, "_obs_trace_id", "")
            meta["leader_trace_id"] = leader_tid

            def on_joined_done(f: Future) -> None:
                self._quotas.release(tenant)
                # the follower's own (one-span) trace, linking the leader's
                obs.TRACER.record(
                    "coalesced.follow", t_submit, time.perf_counter(),
                    category="queue", trace_id=trace_id, parent_id="",
                    tenant=tenant, kind=kind,
                    links=getattr(f, "_obs_trace_id", leader_tid))
                try:
                    payload = f.result()
                except BaseException:
                    return
                self._quotas.record(tenant, key, payload,
                                    len(json.dumps(payload)))

            fut.add_done_callback(on_joined_done)
            return fut, meta

        fut._obs_trace_id = trace_id
        self._count_serve(kind, tenant, "computed")

        def on_done(f: Future) -> None:
            pin_ctx.__exit__(None, None, None)
            self._quotas.release(tenant)
            try:
                payload = f.result()
            except BaseException:
                return
            self._quotas.record(tenant, key, payload,
                                len(json.dumps(payload)))

        fut.add_done_callback(on_done)
        return fut, meta

    # -- observability / lifecycle -------------------------------------------
    def healthz(self) -> Dict[str, object]:
        """Liveness + degradation for the HTTP health endpoint.

        ``status`` is ``"ok"`` or ``"degraded"`` (last refresh or persist
        failed; epoch E is still served, the cause and backoff are
        attached).  A recovered process also reports what its restart did.
        """
        degraded = self._degraded
        with self._db_lock:
            live_epoch = self._db.epoch
        out: Dict[str, object] = {
            "status": "degraded" if degraded else "ok",
            "ok": degraded is None,
            "served_epoch": self._store.current_epoch(),
            "live_epoch": live_epoch,
        }
        if degraded:
            out["degraded"] = dict(degraded)
        if self.recovery is not None:
            out["recovery"] = self.recovery.summary()
        return out

    def stats(self) -> Dict[str, object]:
        """One structure for the stats endpoint and the benchmarks."""
        with self._store.pin() as snap:
            engine_info = snap.engine.cache_info()
        with self._db_lock:
            live_epoch = self._db.epoch
            wal = self._db.wal
            wal_stats = wal.stats() if wal is not None else None
        out = {
            "served_epoch": self._store.current_epoch(),
            "live_epoch": live_epoch,
            "models": self.models(),
            "snapshots": self._store.stats(),
            "scheduler": self._scheduler.stats(),
            "tenants": self._quotas.stats(),
            "engine": engine_info,
            "persistent_compilation_cache":
                persistent_compilation_cache_dir(),
            "uptime_s": round(time.time() - self.started_at, 1),
            "degraded": dict(self._degraded) if self._degraded else None,
        }
        if self._durable_dir is not None:
            out["durability"] = {
                "dir": self._durable_dir,
                "wal": wal_stats,
                "recovery": (self.recovery.summary()
                             if self.recovery else None),
            }
        return out

    def close(self) -> None:
        """Drain and stop: terminal, idempotent.

        In-flight requests complete (their futures resolve with results or
        their work's exception); queued-but-unstarted ones fail fast with
        :class:`ServiceClosed`.  The WAL is flushed and closed last, after
        no worker can mutate through the service anymore.
        """
        self._scheduler.close(wait=True)
        with self._db_lock:
            self._db.detach_wal()

    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
