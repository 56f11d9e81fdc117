"""Top-level graph extraction (Definitions 2.2 / 3.1).

The plan/execute machinery lives here; the public entry point is
:class:`repro_torch.api.ExtractionEngine`, which adds cross-request plan and
materialized-view caching on top of these primitives.

``extract_graph(db, model, method=...)`` is kept as a deprecated wrapper
over a throwaway engine and runs one of:

* ``extgraph`` — Alg 2 hybrid plan (JS-OJ + JS-MV), the paper's method
* ``extgraph-oj`` / ``extgraph-mv`` — ablations (Fig 16's middle bars)
* ``ringo`` / ``graphgen`` / ``r2gsync`` — baselines (see baselines.py);
  :func:`plan_queries` returns ``None`` for them

All methods return the same user-intended graph: {vertex label: Table},
{edge label: Table(src, dst)}; timings split extraction vs conversion the
way the paper reports them (conversion != 0 only for GraphGen/R2GSync).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import baselines
from repro_torch.core.database import Database
from repro_torch.core.executor import (
    edge_output,
    ensure_view,
    execute_merged,
    execute_query,
)
from repro_torch.core.jsmv import ViewDef
from repro_torch.core.model import GraphModel
from repro_torch.core.planner import ExtractionPlan, optimize
from repro_torch.relational import Table

BASELINE_METHODS = ("ringo", "graphgen", "r2gsync")
PLANNED_METHODS = ("extgraph", "extgraph-oj", "extgraph-mv")


def synchronize_tables(tables) -> None:
    """Wait for the device work producing ``tables`` (no-op on the CPU)."""
    devices = {t.device for t in tables if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class ExtractedGraph:
    vertices: Dict[str, Table]
    edges: Dict[str, Table]
    _fp: Optional[str] = dataclasses.field(default=None, repr=False,
                                           compare=False)

    def block_until_ready(self):
        synchronize_tables(list(self.vertices.values())
                           + list(self.edges.values()))
        return self

    def fingerprint(self) -> str:
        """Content address over all vertex/edge tables (valid rows only).

        Two extractions that produced the same graph — whatever method,
        plan, or implementation got them there — share a fingerprint.
        Memoized: the tables are immutable.
        """
        if self._fp is not None:
            return self._fp
        import hashlib

        from repro_torch.relational.ops import table_digest

        h = hashlib.sha1()
        for kind, tables in (("v", self.vertices), ("e", self.edges)):
            for label in sorted(tables):
                h.update(f"{kind}:{label}:".encode())
                h.update(table_digest(tables[label]).encode())
        self._fp = h.hexdigest()[:16]
        return self._fp


@dataclasses.dataclass
class Timings:
    plan_s: float = 0.0
    extract_s: float = 0.0
    convert_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.plan_s + self.extract_s + self.convert_s


def extract_vertices(db: Database, model: GraphModel) -> Dict[str, Table]:
    out = {}
    for v in model.vertices:
        t = db.table(v.table)
        cols = {"id": t[v.id_col]}
        for p in v.props:
            cols[p] = t[p]
        out[v.label] = Table(columns=cols, valid=t.valid)
    return out


def run_plan(
    db: Database, plan: ExtractionPlan, compiler=None,
) -> Tuple[Dict[str, Table], List[str], List[str]]:
    """Execute a plan; returns (edges, views built, views reused).

    ``plan.reused`` views must already be registered in ``db``; ``plan.views``
    entries that happen to be registered too (a cached plan replayed against
    a warm view cache) are skipped and counted as reused.

    With a :class:`repro_torch.core.pipeline.PipelineCompiler`, every view
    and unit runs as one pre-sized unit function (static capacities from
    the cost model, on-device overflow detection, one host sync per unit)
    instead of the eager two-phase count→expand path; the two paths produce
    identical bags of valid rows.
    """
    built: List[str] = []
    reused: List[str] = [v.name for v in plan.reused]
    for v in plan.views:
        # structural span: emitted for both the eager and the compiled
        # path, so the two produce identical span-tree shapes
        with obs.span(f"view:{v.name}", category="execute") as sp:
            if ensure_view(db, v.name, v.as_query(), compiler=compiler):
                built.append(v.name)
                sp.set(built=True)
            else:
                reused.append(v.name)
                sp.set(built=False)
    edges: Dict[str, Table] = {}
    for u in plan.units:
        if u.is_single:
            with obs.span(f"unit:{u.single.name}", category="execute",
                          unit_kind="single"):
                if compiler is None:
                    res = execute_query(db, u.single)
                    edges[u.single.name] = edge_output(res, u.single.src,
                                                       u.single.dst)
                else:
                    edges[u.single.name] = compiler.run_query_edges(
                        db, u.single)
        else:
            label = "+".join(u.group.member_names())
            with obs.span(f"unit:{label}", category="execute",
                          unit_kind="merged"):
                if compiler is None:
                    edges.update(execute_merged(db, u.group))
                else:
                    edges.update(compiler.run_merged(db, u.group))
    return edges, built, reused


def execute_plan(db: Database, plan: ExtractionPlan,
                 compiler=None) -> Dict[str, Table]:
    """Materialize views in order, then run every unit (edges only)."""
    return run_plan(db, plan, compiler=compiler)[0]


def _ablation_plan(db: Database, queries, oj_only: bool,
                   cached_views: Sequence[ViewDef] = ()) -> ExtractionPlan:
    """Greedy Alg 2 restricted to one move type (Fig 16's JS-OJ / JS-MV bars)."""
    from repro_torch.core.planner import (
        PlanUnit, _mv_candidates, _oj_candidates, plan_cost)
    plan = ExtractionPlan(
        views=(), units=tuple(PlanUnit(single=q) for q in queries))
    best = plan_cost(db, plan)
    while True:
        cands = (_oj_candidates(plan) if oj_only
                 else _mv_candidates(plan, cached_views))
        scored = []
        for c in cands:
            try:
                scored.append((plan_cost(db, c), c))
            except (ValueError, AssertionError, KeyError):
                continue
        if not scored:
            break
        scored.sort(key=lambda t: t[0])
        if scored[0][0] < best:
            best, plan = scored[0][0], scored[0][1]
        else:
            break
    return plan


def plan_queries(db: Database, queries, method: str, verbose: bool = False,
                 cached_views: Sequence[ViewDef] = ()) -> Optional[ExtractionPlan]:
    """Plan for one of the planned methods; None for the baselines."""
    if method == "extgraph":
        return optimize(db, queries, verbose=verbose,
                        cached_views=cached_views)
    if method in ("extgraph-oj", "extgraph-mv"):
        return _ablation_plan(db, queries, oj_only=(method == "extgraph-oj"),
                              cached_views=cached_views)
    if method in BASELINE_METHODS:
        return None
    raise ValueError(f"unknown method {method!r}")


def run_baseline(db: Database, queries, method: str):
    """Execute one of the non-planned methods; returns (edges, ext_s, conv_s)."""
    if method == "ringo":
        t0 = time.perf_counter()
        edges = {}
        for q in queries:
            res = execute_query(db, q)
            edges[q.name] = edge_output(res, q.src, q.dst)
            synchronize_tables([edges[q.name]])
        return edges, time.perf_counter() - t0, 0.0
    if method == "graphgen":
        return baselines.run_graphgen(db, queries)
    if method == "r2gsync":
        return baselines.run_r2gsync(db, queries)
    raise ValueError(f"unknown baseline {method!r}")


def extract_graph(
    db: Database,
    model: GraphModel,
    method: str = "extgraph",
    verbose: bool = False,
) -> Tuple[ExtractedGraph, Timings]:
    """Definition 3.1's four steps, timed.

    .. deprecated::
        One-shot entry point kept for compatibility; it re-plans and
        re-materializes everything on every call.  Use
        :class:`repro_torch.api.ExtractionEngine` to share plans and views
        across requests.
    """
    warnings.warn(
        "extract_graph() is deprecated; use repro_torch.api.ExtractionEngine, "
        "which caches plans and materialized views across requests",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import ExtractionEngine  # lazy: api builds on core

    result = ExtractionEngine(db).extract(model, method=method,
                                          verbose=verbose)
    return result.graph, result.timings
