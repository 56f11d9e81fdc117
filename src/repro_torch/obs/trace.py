"""Structured tracer: nested spans with compile/execute attribution.

Every request — served or scripted — gets a **trace**: a bounded list of
spans with ids, parents, wall times, and a *category* that attributes the
time to one of the phases the ExtGraph claims are made of::

    plan | compile | execute | transfer | csr | queue | other

Spans nest through a :mod:`contextvars` context, so instrumentation deep
inside the pipeline lands under whatever request span is active on the
thread — the serving layer activates the request's trace inside the worker
thread before calling into the engine.

Two kinds of spans:

* **structural** spans name the request taxonomy (``engine.extract`` →
  ``plan`` / ``execute`` → ``view:*`` / ``unit:*`` → ``vertices``).  Their
  tree *shape* is a path-independent oracle: the eager reference path and
  the compiled pipeline emit identical structural trees for the same model
  (only durations differ) — tested in ``tests/test_obs.py``.
* **detail** spans (``detail=True``) attribute time inside a structural
  span (per-unit ``pipeline.compile`` / ``pipeline.run`` /
  ``pipeline.sync``, overflow retries).  They are excluded from shape
  comparison — the compiled path legitimately has more of them.

Cost: a span is one ``perf_counter`` pair, a contextvar set/reset and one
short-held lock on exit (~1-2 µs); with :func:`set_enabled` ``(False)``
``span()`` returns a shared no-op (< 1 µs).  No device syncs anywhere.
The trace store is a ring: at most ``max_traces`` retained traces of at
most ``max_spans`` spans each — an abandoned span flood cannot OOM a
server.

Exports: JSON (span list), Chrome ``chrome://tracing`` / Perfetto event
format (:meth:`Tracer.chrome`), and an attribution summary
(:meth:`Tracer.summary`) whose ``coverage`` is the fraction of the root
span's wall time attributed to a named phase.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

#: attribution categories a span may carry ("" -> other)
CATEGORIES = ("plan", "compile", "execute", "transfer", "csr", "queue")

_CTX: contextvars.ContextVar[Optional[Tuple[str, str]]] = \
    contextvars.ContextVar("repro_obs_span", default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def sanitize_trace_id(raw: Optional[str]) -> Optional[str]:
    """A caller-supplied id (e.g. an ``X-Request-Id`` header), made safe."""
    if not raw:
        return None
    cleaned = "".join(c for c in str(raw).strip() if c.isalnum() or c in "-_")
    return cleaned[:64] or None


class _NoopSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()
    trace_id = ""
    span_id = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _Span:
    """Live span handle; becomes a plain dict in the trace store on exit."""

    __slots__ = ("_tracer", "name", "category", "detail", "attrs",
                 "trace_id", "span_id", "parent_id", "_start", "_token",
                 "_thread")

    def __init__(self, tracer: "Tracer", name: str, category: str,
                 detail: bool, trace_id: Optional[str],
                 start_s: Optional[float], attrs: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.category = category
        self.detail = detail
        self.attrs = attrs
        parent = _CTX.get()
        if parent is not None:
            self.trace_id, self.parent_id = parent[0], parent[1]
        else:
            self.trace_id = trace_id or new_trace_id()
            self.parent_id = ""
        self.span_id = tracer._next_id()
        self._start = time.perf_counter() if start_s is None else start_s
        self._thread = threading.get_ident()
        self._token = _CTX.set((self.trace_id, self.span_id))

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _CTX.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._store({
            "trace": self.trace_id, "id": self.span_id,
            "parent": self.parent_id, "name": self.name,
            "category": self.category, "detail": self.detail,
            "start_s": self._start,
            "dur_s": time.perf_counter() - self._start,
            "thread": self._thread, "attrs": self.attrs,
        })
        return False


class Tracer:
    """Bounded store of traces plus the span entry points."""

    def __init__(self, max_traces: int = 256, max_spans: int = 4096,
                 enabled: bool = True):
        self.max_traces = int(max_traces)
        self.max_spans = int(max_spans)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, Dict]" = \
            collections.OrderedDict()
        self._ids = itertools.count(1)

    # -- recording -----------------------------------------------------------
    def _next_id(self) -> str:
        return f"{next(self._ids):x}"

    def span(self, name: str, category: str = "", detail: bool = False,
             trace_id: Optional[str] = None, start_s: Optional[float] = None,
             **attrs):
        """Context manager opening a span under the current one (or a new
        trace root).  ``trace_id`` only applies when starting a root;
        ``start_s`` backdates the span (e.g. to a request's submit time)."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, category, detail, trace_id, start_s, attrs)

    def record(self, name: str, start_s: float, end_s: float,
               category: str = "", detail: bool = False,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, **attrs) -> None:
        """Record an already-measured span (no contextvar involvement
        unless ``trace_id``/``parent_id`` are omitted, in which case the
        current span is the parent)."""
        if not self.enabled:
            return
        if trace_id is None or parent_id is None:
            cur = _CTX.get()
            if trace_id is None:
                trace_id = cur[0] if cur else new_trace_id()
            if parent_id is None:
                parent_id = cur[1] if cur else ""
        self._store({
            "trace": trace_id, "id": self._next_id(), "parent": parent_id,
            "name": name, "category": category, "detail": detail,
            "start_s": start_s, "dur_s": max(0.0, end_s - start_s),
            "thread": threading.get_ident(), "attrs": attrs,
        })

    def current(self) -> Optional[Tuple[str, str]]:
        """(trace_id, span_id) of the active span on this context."""
        return _CTX.get()

    def _store(self, span: Dict) -> None:
        with self._lock:
            entry = self._traces.get(span["trace"])
            if entry is None:
                entry = {"spans": [], "dropped": 0}
                self._traces[span["trace"]] = entry
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            if len(entry["spans"]) >= self.max_spans:
                entry["dropped"] += 1
            else:
                entry["spans"].append(span)

    # -- retrieval / export --------------------------------------------------
    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def get(self, trace_id: str) -> Optional[List[Dict]]:
        with self._lock:
            entry = self._traces.get(trace_id)
            return None if entry is None else list(entry["spans"])

    def list_traces(self, limit: int = 50) -> List[Dict]:
        """Newest-last digest of recent traces (``GET /v1/traces``).

        One entry per retained trace: id, root span name + category,
        root wall time, span count, dropped count.  A trace whose root
        span has not closed yet reports ``root=""`` / ``wall_s=0.0`` —
        listing must never block on in-flight requests.
        """
        limit = max(1, int(limit))
        with self._lock:
            items = [(tid, list(entry["spans"]), entry["dropped"])
                     for tid, entry in list(self._traces.items())[-limit:]]
        out: List[Dict] = []
        for tid, spans, dropped in items:
            root = min((s for s in spans if not s["parent"]),
                       key=lambda s: s["start_s"], default=None)
            out.append({
                "trace_id": tid,
                "root": root["name"] if root else "",
                "category": (root["category"] or "other") if root else "",
                "wall_s": root["dur_s"] if root else 0.0,
                "spans": len(spans),
                "dropped": dropped,
            })
        return out

    def dropped(self, trace_id: str) -> int:
        with self._lock:
            entry = self._traces.get(trace_id)
            return 0 if entry is None else entry["dropped"]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def chrome(self, trace_id: str) -> Optional[Dict]:
        """Chrome ``chrome://tracing`` / Perfetto ``traceEvents`` JSON."""
        spans = self.get(trace_id)
        if spans is None:
            return None
        events = []
        for s in spans:
            events.append({
                "name": s["name"], "ph": "X", "pid": 1, "tid": s["thread"],
                "ts": round(s["start_s"] * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "cat": s["category"] or "other",
                "args": {**s["attrs"], "span_id": s["id"],
                         "parent_id": s["parent"]},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"trace_id": trace_id}}

    def summary(self, trace_id: str) -> Optional[Dict]:
        """Wall time + per-category attribution for one trace.

        Each span's *self time* (duration minus direct children) is
        attributed to its category; ``coverage`` is the attributed
        fraction of the root span's wall time — the acceptance metric
        ("spans cover ≥95% of the request with plan/compile/execute/CSR/
        queue attribution").
        """
        spans = self.get(trace_id)
        if not spans:
            return None
        children_dur: Dict[str, float] = collections.defaultdict(float)
        for s in spans:
            if s["parent"]:
                children_dur[s["parent"]] += s["dur_s"]
        root = min((s for s in spans if not s["parent"]),
                   key=lambda s: s["start_s"], default=spans[0])
        by_cat: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        by_cat["other"] = 0.0
        for s in spans:
            self_s = max(0.0, s["dur_s"] - children_dur.get(s["id"], 0.0))
            by_cat[s["category"] if s["category"] in by_cat else "other"] \
                += self_s
        wall = root["dur_s"]
        attributed = sum(v for c, v in by_cat.items() if c != "other")
        return {
            "trace_id": trace_id,
            "root": root["name"],
            "wall_s": wall,
            "spans": len(spans),
            "dropped": self.dropped(trace_id),
            "by_category_s": by_cat,
            "attributed_s": attributed,
            "coverage": min(1.0, attributed / wall) if wall > 0 else 0.0,
        }

    def breakdown(self, trace_id: str) -> Dict[str, float]:
        """Flat per-phase seconds for benchmark artifacts.

        Always carries ``compile_s`` and ``execute_s`` (the fields the CI
        bench-smoke job asserts on), plus wall/coverage and the remaining
        categories.
        """
        s = self.summary(trace_id)
        if s is None:
            return {"wall_s": 0.0, "compile_s": 0.0, "execute_s": 0.0,
                    "plan_s": 0.0, "transfer_s": 0.0, "csr_s": 0.0,
                    "queue_s": 0.0, "other_s": 0.0, "coverage": 0.0}
        cats = s["by_category_s"]
        return {"wall_s": s["wall_s"],
                "plan_s": cats["plan"], "compile_s": cats["compile"],
                "execute_s": cats["execute"], "transfer_s": cats["transfer"],
                "csr_s": cats["csr"], "queue_s": cats["queue"],
                "other_s": cats["other"], "coverage": s["coverage"]}


def span_tree_shape(spans: List[Dict],
                    include_detail: bool = False) -> Tuple:
    """Nested ``(name, (children...))`` shape of a trace's structural spans.

    Detail spans (per-unit compile/run/sync, retries) are excluded unless
    ``include_detail`` — the structural shape is the path-independent
    oracle the eager-vs-compiled parity test compares.  Children are
    ordered by start time.
    """
    by_parent: Dict[str, List[Dict]] = collections.defaultdict(list)
    detail_ids = {s["id"] for s in spans if s["detail"]}
    # a structural span under a detail span is lifted to the nearest
    # structural ancestor so detail exclusion never orphans it
    parent_of = {s["id"]: s["parent"] for s in spans}

    def structural_parent(pid: str) -> str:
        while pid in detail_ids:
            pid = parent_of.get(pid, "")
        return pid

    for s in spans:
        if s["detail"] and not include_detail:
            continue
        pid = s["parent"] if include_detail else structural_parent(s["parent"])
        by_parent[pid].append(s)
    for kids in by_parent.values():
        kids.sort(key=lambda s: s["start_s"])

    def shape(span: Dict) -> Tuple:
        return (span["name"],
                tuple(shape(c) for c in by_parent.get(span["id"], ())))

    roots = by_parent.get("", [])
    return tuple(shape(r) for r in roots)


#: The process-wide default tracer every instrumented layer reports to.
TRACER = Tracer()


def span(name: str, category: str = "", detail: bool = False,
         trace_id: Optional[str] = None, start_s: Optional[float] = None,
         **attrs):
    """Open a span on the default tracer (the usual instrumentation call)."""
    return TRACER.span(name, category=category, detail=detail,
                       trace_id=trace_id, start_s=start_s, **attrs)


def set_enabled(enabled: bool) -> None:
    """Toggle the default tracer (metrics are unaffected)."""
    TRACER.enabled = bool(enabled)
