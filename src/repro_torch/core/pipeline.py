"""Compiled extraction pipelines: one pre-sized unit function per PlanUnit.

The eager executor (:mod:`repro_torch.core.executor`) runs every join in two
phases — an exact ``join_count`` with a host round-trip to size the output,
then the expansion.  That materialization barrier per operator is exactly
what GraphGen and the Vertica graph work identify as the cost of
operator-at-a-time extraction.  This module removes it:

* **Capacity planning** — the cost model's cardinality estimates
  (:func:`repro_torch.core.cost.step_expansions`) pre-size every
  intermediate to a pow-2-bucketed static capacity *before* execution.
* **Whole-unit functions** — each :class:`~repro_torch.core.planner.PlanUnit`'s
  full dataflow (scans → join chain → post-filters → outer-join branches →
  edge projection) runs as **one** function of the unit's input tables with
  no host syncs in the middle: every kernel is queued on the device stream.
  Joins report their exact required row count on-device; the host syncs
  once per unit, and an overflowed step triggers a re-execution at the
  (bucketed) exact capacity.
* **Unit cache** — built unit functions are content-addressed by (unit
  signature, join orders, capacity-bucket vector, kernel flags,
  input-schema fingerprint) in a process-wide store, keyed exactly as the
  JAX package keys its executables.  PyTorch runs eagerly, so what is
  cached is the built function; capturing each as a CUDA graph is the
  next step.
* **Column liveness** — each join step gathers only the columns that the
  rest of its unit reads after it (later steps' conditions, its own
  post-filters, the unit's outputs), worked out once per unit function;
  a JS-OJ member is cut to its dedup keys and edge ends before its dedup.
  Views keep every column: later queries are rewritten over them.
* **Kernels** — with ``use_kernel`` (auto-on for CUDA via
  :func:`repro_torch.kernels.ops.resolve_use_kernel`) the join probe runs
  the ``sorted_probe`` kernel, the pair expansion the ``join_expand``
  kernel, and each join prunes probe rows through the
  ``bloom`` semi-join prefilter kernels before the capacity expansion; on
  the CPU the wrappers take the plain versions.

XLA's tiered compilation has no counterpart here; its ``stats`` keys
(``tiered``, ``reoptimized``) stay at 0.  The counterpart of the JAX
package's persistent compilation cache is the directory of the built
kernel libraries (:func:`enable_persistent_compilation_cache`).

Bag semantics are identical to the eager path: capacities only change
padding, never the set of valid rows.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cost import estimate_query, scan_estimate, step_expansions
from repro_torch.core.database import Database
from repro_torch.core.executor import edge_output, qualified_cond, scan_table
from repro_torch.core.jsoj import MergedQuery, shared_query
from repro_torch.core.model import JoinQuery, join_schedule, query_signature
from repro_torch.kernels import _build
from repro_torch.kernels.ops import bloom_bits_for, resolve_use_kernel
from repro_torch.relational import Table, dedup
from repro_torch.relational.join import (
    _round_capacity,
    join_with_capacity,
    left_outer_with_capacity,
)

# Safety factor applied to cardinality estimates before pow-2 bucketing;
# System-R estimates undershoot under Zipf skew, and a bucket that survives
# the first run saves a whole retry (re-execution).
CAPACITY_MARGIN = 2.0

_EXECUTABLE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_EXECUTABLE_CACHE_SIZE = 256
_CACHE_LOCK = threading.Lock()


def clear_executable_cache() -> None:
    """Drop every built unit function (process-wide store)."""
    with _CACHE_LOCK:
        _EXECUTABLE_CACHE.clear()


# Opt-in on-disk cache of what a cold start builds.  Unit functions are
# Python closures and are rebuilt in microseconds; what a restarted process
# would compile again is the CUDA kernels (``nvcc``, seconds each), so the
# directory is where :mod:`repro_torch.kernels._build` writes and loads the
# built ``.so`` files.  Enabled via the REPRO_COMPILATION_CACHE env var or
# an explicit path (engine kwarg / GraphService), as in the JAX package.
# Process-global because the kernel libraries are.
PERSISTENT_CACHE_ENV = "REPRO_COMPILATION_CACHE"
_PERSISTENT_CACHE_DIR: Optional[str] = None
_PERSISTENT_CACHE_LOCK = threading.Lock()


def enable_persistent_compilation_cache(
        path: Optional[str] = None) -> Optional[str]:
    """Point the kernel build directory at ``path`` (opt-in).

    ``path`` defaults to the ``REPRO_COMPILATION_CACHE`` environment
    variable; when neither is set this is a no-op returning ``None`` and
    the kernels build under ``build/kernels/`` at the repository root.
    Libraries already loaded stay loaded; the next one to load is built
    into (or found in) ``path``.  Idempotent, and a later call with another
    path re-points it; returns the directory in effect.
    """
    global _PERSISTENT_CACHE_DIR
    path = path or os.environ.get(PERSISTENT_CACHE_ENV)
    if not path:
        return None
    path = os.path.abspath(os.path.expanduser(path))
    with _PERSISTENT_CACHE_LOCK:
        if _PERSISTENT_CACHE_DIR == path:
            return path
        os.makedirs(path, exist_ok=True)
        _build.set_build_dir(path)
        _PERSISTENT_CACHE_DIR = path
    return path


def persistent_compilation_cache_dir() -> Optional[str]:
    """The directory enabled via :func:`enable_persistent_compilation_cache`
    (``None`` when the feature is off)."""
    return _PERSISTENT_CACHE_DIR


@dataclasses.dataclass(frozen=True)
class UnitProgram:
    """Host-side description of one unit's dataflow, ready to run.

    ``kind`` is ``"query"`` (bare join result, used for views), ``"edges"``
    (query + src/dst edge projection) or ``"merged"`` (a JS-OJ group).
    ``capacities`` holds one static capacity per join step, in the exact
    order the unit function consumes them: main/S chain first, then per
    branch its inner chain followed by its outer-join attachment.
    """

    kind: str
    unit: object                          # JoinQuery | MergedQuery
    orders: Tuple[Tuple[str, ...], ...]   # (main,) or (S, branch, ...)
    capacities: Tuple[int, ...]
    inputs: Tuple[str, ...]               # base-table / view names read
    signature: object                     # hashable cache identity
    est_rows: Tuple[float, ...] = ()      # cost-model rows per join step


# ---------------------------------------------------------------------------
# Capacity planning
# ---------------------------------------------------------------------------

def _bucket(rows: float, margin: float, clamp: Optional[int]) -> int:
    cap = _round_capacity(int(rows * margin))
    if clamp is not None:
        cap = min(cap, max(8, clamp))
    return cap


def _query_inputs(query: JoinQuery) -> Tuple[str, ...]:
    return tuple(sorted({r.table for r in query.relations}))


def _merged_inputs(merged: MergedQuery) -> Tuple[str, ...]:
    names = {r.table for r in merged.pattern.relations}
    for b in merged.branches:
        names |= {r.table for r in b.relations}
    return tuple(sorted(names))


def build_query_program(
    db: Database, query: JoinQuery, edges: bool,
    margin: float = CAPACITY_MARGIN, clamp: Optional[int] = None,
) -> UnitProgram:
    """Pre-size a single query's join chain from the cost model."""
    est = estimate_query(db, query)
    rows = tuple(step_expansions(db, query, est.order))
    return UnitProgram(
        kind="edges" if edges else "query",
        unit=query,
        orders=(est.order,),
        capacities=tuple(_bucket(r, margin, clamp) for r in rows),
        inputs=_query_inputs(query),
        signature=("q", query_signature(query), edges),
        est_rows=rows,
    )


def build_merged_program(
    db: Database, merged: MergedQuery,
    margin: float = CAPACITY_MARGIN, clamp: Optional[int] = None,
) -> UnitProgram:
    """Pre-size a JS-OJ group: S chain, branch chains, outer attachments.

    Outer-join capacities follow Eq 3/4's expansion estimate but on the
    *first* link condition only (further conditions are post-filters of the
    static expansion, mirroring the executor's contract); the running row
    estimate between branches uses every condition.
    """
    sq = shared_query(merged)
    s_est = estimate_query(db, sq)
    orders: List[Tuple[str, ...]] = [s_est.order]
    cap_rows: List[float] = list(step_expansions(db, sq, s_est.order))
    rows = s_est.rows
    s_rel = s_est.to_rel()
    for b in merged.branches:
        if not b.relations:
            orders.append(())        # indicator-only branch: no join
            continue
        if len(b.relations) > 1:
            b_q = b.as_query()
            b_est = estimate_query(db, b_q)
            orders.append(b_est.order)
            cap_rows.extend(step_expansions(db, b_q, b_est.order))
            b_rel = b_est.to_rel()
        else:
            orders.append((b.relations[0].alias,))
            b_rel = scan_estimate(db, b.relations[0])
        sel_first = sel_all = 1.0
        for i, c in enumerate(b.link_conds):
            s = 1.0 / max(s_rel.col_ndv(c.left, c.lcol),
                          b_rel.col_ndv(c.right, c.rcol))
            if i == 0:
                sel_first = s
            sel_all *= s
        # unmatched left rows also occupy slots (counts = max(match, 1))
        cap_rows.append(rows * max(1.0, b_rel.rows * sel_first) + rows)
        rows *= max(1.0, b_rel.rows * sel_all)
    return UnitProgram(
        kind="merged",
        unit=merged,
        orders=tuple(orders),
        capacities=tuple(_bucket(r, margin, clamp) for r in cap_rows),
        inputs=_merged_inputs(merged),
        signature=("m", merged),
        est_rows=tuple(cap_rows),
    )


# ---------------------------------------------------------------------------
# Unit execution (no host syncs inside a unit)
# ---------------------------------------------------------------------------

def _scan(tables: Dict[str, Table], rel, needed=None) -> Table:
    """:func:`executor.scan_table` plus projection pushdown.

    ``needed`` (a set of qualified column names, or None for keep-all) drops
    every column the rest of the unit never references — scan filters are
    applied first, so filter columns need not survive the projection.
    Fewer columns means fewer gathers per join step: less to move.
    """
    t = scan_table(tables[rel.table], rel)
    if needed is not None:
        keep = [c for c in t.column_names() if c in needed]
        if keep and len(keep) < len(t.columns):
            t = t.select(keep)
    return t


def _cond_columns(conds) -> set:
    """Qualified columns of both endpoints of each condition."""
    return ({f"{c.left}.{c.lcol}" for c in conds}
            | {f"{c.right}.{c.rcol}" for c in conds})


def _needed_columns_query(query: JoinQuery) -> set:
    """Qualified columns a query's joins, post-filters, and outputs touch."""
    return _cond_columns(query.conds) | {query.src.qualified(),
                                         query.dst.qualified()}


def _needed_columns_merged(merged: MergedQuery) -> set:
    need = _needed_columns_query(shared_query(merged))
    for b in merged.branches:
        need |= _cond_columns(b.inner_conds + b.link_conds)
    for m in merged.members:
        need |= _cond_columns(m.residual_conds)
        need |= {m.src.qualified(), m.dst.qualified()}
    return need


# ---------------------------------------------------------------------------
# Column liveness: what each join step gathers
# ---------------------------------------------------------------------------

def _chain_reads(query: JoinQuery, order: Sequence[str]) -> list:
    """A join chain's steps as ``(key, post)`` column reads: ``key`` the
    first condition's columns (read to build the sort keys, before the
    expansion), ``post`` the post-filter and closing conditions' (read
    from the step's output)."""
    return [(_cond_columns(conds[:1]), _cond_columns(conds[1:] + closing))
            for _, conds, closing in join_schedule(query, order)]


def _live_gathers(reads: Sequence[Tuple[Optional[set], set]],
                  tail: set) -> Tuple[frozenset, ...]:
    """Per join step, the columns it gathers: its own ``post`` columns and
    every column read after it, by later steps or by ``tail`` (the unit's
    outputs).  ``reads`` is in execution order; an entry whose ``key`` is
    ``None`` reads ``post`` between steps without joining."""
    live = set(tail)
    gathers = []
    for key, post in reversed(reads):
        if key is not None:
            gathers.append(frozenset(live | post))
            live |= key
        live |= post
    return tuple(reversed(gathers))


def _gather_sets(program: "UnitProgram") -> Tuple[Optional[frozenset], ...]:
    """Each join step's gather set, in ``program.capacities`` order; None
    (every column) for the steps of a view (``kind == "query"``), which
    keeps every column because later queries are rewritten over it."""
    if program.kind == "query":
        return (None,) * len(program.capacities)
    unit = program.unit
    if program.kind == "edges":
        return _live_gathers(_chain_reads(unit, program.orders[0]),
                             {unit.src.qualified(), unit.dst.qualified()})
    reads = _chain_reads(shared_query(unit), program.orders[0])
    tail = {"__srow__"}
    for bi, b in enumerate(unit.branches):
        tail.add(f"__m__{b.id}")
        if not b.relations:
            reads.append((None, _cond_columns(b.link_conds)))
            continue
        tail.add(f"__brow__{b.id}")
        if len(b.relations) > 1:
            reads += _chain_reads(b.as_query(), program.orders[1 + bi])
        reads.append((_cond_columns(b.link_conds[:1]),
                      _cond_columns(b.link_conds[1:])))
    for m in unit.members:
        tail |= _cond_columns(m.residual_conds)
        tail |= {m.src.qualified(), m.dst.qualified()}
    return _live_gathers(reads, tail)


def _join_span():
    """The detail span around one join step, timed on the device too."""
    return obs.span("pipeline.join", category="execute", detail=True,
                    device=True)


def _row_bytes(left: Table, right: Table, gather=None) -> int:
    """Bytes of one output row of a join: the columns of both sides named
    in ``gather`` (every column when ``None``) are gathered into it."""
    return sum(c.element_size() for t in (left, right)
               for n, c in t.columns.items() if gather is None or n in gather)


def _record_widths(widths: Optional[list], left: Table, right: Table,
                   gather, lost: int) -> int:
    """Append a step's row bytes, (gathered, every column), to ``widths``.

    "Every column" is what the step would gather had no step pruned: the
    columns of both sides plus ``lost``, the bytes of the columns that
    earlier steps left out of them.  Returns what the step's output lacks
    in turn (0 when ``widths`` is None: nothing is recorded)."""
    if widths is None:
        return 0
    kept = _row_bytes(left, right, gather)
    every = _row_bytes(left, right) + lost
    widths.append((kept, every))
    return every - kept


def _traced_query(
    tables: Dict[str, Table],
    query: JoinQuery,
    order: Sequence[str],
    caps_iter,
    gathers_iter,
    totals: List[torch.Tensor],
    widths: Optional[list],
    use_kernel: bool,
    use_bloom: bool,
    needed=None,
) -> Tuple[Table, int]:
    """The executor's join chain, with static capacities and no host syncs.

    Same schedule as :func:`executor.execute_query` — both walk
    :func:`repro_torch.core.model.join_schedule`, which is what keeps the
    pre-planned capacities aligned with the joins actually run.  Each step
    gathers the columns ``gathers_iter`` yields for it (None: all), appends
    its exact requirement to ``totals`` and, when ``widths`` is given, its
    row bytes to ``widths`` (:func:`_record_widths`).  Returns the chain's
    table and the row bytes it lacks against a chain that prunes nothing.
    """
    cur = _scan(tables, query.relation(order[0]), needed)
    lost = 0
    for alias, conds, closing in join_schedule(query, order):
        nxt = _scan(tables, query.relation(alias), needed)
        on = [qualified_cond(c, alias) for c in conds]
        gather = next(gathers_iter)
        lost = _record_widths(widths, cur, nxt, gather, lost)
        with _join_span():
            cur, required = join_with_capacity(
                cur, nxt, on, how="inner", capacity=next(caps_iter),
                use_kernel=use_kernel,
                bloom_bits=bloom_bits_for(nxt.capacity) if use_bloom else 0,
                gather=gather)
        totals.append(required)
        for c in closing:
            cur = cur.mask(cur[f"{c.left}.{c.lcol}"]
                           == cur[f"{c.right}.{c.rcol}"])
    return cur, lost


def _traced_merged(
    tables: Dict[str, Table],
    merged: MergedQuery,
    orders: Sequence[Tuple[str, ...]],
    caps_iter,
    gathers_iter,
    totals: List[torch.Tensor],
    widths: Optional[list],
    use_kernel: bool,
    use_bloom: bool,
) -> Dict[str, Table]:
    """The executor's JS-OJ evaluation (Theorem 4.3), with no host syncs.

    Each member is cut to its dedup keys, src and dst once its rows are
    masked, so its dedup sorts and gathers only those."""
    needed = _needed_columns_merged(merged)
    cur, lost = _traced_query(tables, shared_query(merged), orders[0],
                              caps_iter, gathers_iter, totals, widths,
                              use_kernel, use_bloom, needed)
    dev = cur.device
    cur = cur.with_columns(
        __srow__=torch.arange(cur.capacity, dtype=torch.int32, device=dev))
    indicators: Dict[str, str] = {}
    rowid_cols: Dict[str, str] = {}
    for bi, b in enumerate(merged.branches):
        ind = f"__m__{b.id}"
        indicators[b.id] = ind
        if not b.relations:
            mask = torch.ones((cur.capacity,), dtype=torch.bool, device=dev)
            for c in b.link_conds:
                mask = mask & (cur[f"{c.left}.{c.lcol}"]
                               == cur[f"{c.right}.{c.rcol}"])
            cur = cur.with_columns(**{ind: mask})
            continue
        if len(b.relations) > 1:
            branch_tbl, branch_lost = _traced_query(
                tables, b.as_query(), orders[1 + bi], caps_iter,
                gathers_iter, totals, widths, use_kernel, use_bloom, needed)
        else:
            branch_tbl = _scan(tables, b.relations[0], needed)
            branch_lost = 0
        brow = f"__brow__{b.id}"
        rowid_cols[b.id] = brow
        branch_tbl = branch_tbl.with_columns(
            **{brow: torch.arange(branch_tbl.capacity, dtype=torch.int32,
                                  device=dev)})
        on = [(f"{c.left}.{c.lcol}", f"{c.right}.{c.rcol}")
              for c in b.link_conds]
        gather = next(gathers_iter)
        lost = _record_widths(widths, cur, branch_tbl, gather,
                              lost + branch_lost)
        with _join_span():
            cur, required = left_outer_with_capacity(
                cur, branch_tbl, on, ind, capacity=next(caps_iter),
                use_kernel=use_kernel,
                bloom_bits=bloom_bits_for(branch_tbl.capacity)
                if use_bloom else 0, gather=gather)
        totals.append(required)

    out: Dict[str, Table] = {}
    for m in merged.members:
        keep = torch.ones((cur.capacity,), dtype=torch.bool, device=dev)
        for bid in m.branch_ids:
            keep = keep & cur[indicators[bid]]
        for c in m.residual_conds:
            keep = keep & (cur[f"{c.left}.{c.lcol}"]
                           == cur[f"{c.right}.{c.rcol}"])
        dedup_keys = ["__srow__"] + [
            rowid_cols[bid] for bid in m.branch_ids if bid in rowid_cols
        ]
        member_rows = cur.mask(keep).select(dict.fromkeys(
            dedup_keys + [m.src.qualified(), m.dst.qualified()]))
        member_rows = dedup(member_rows, dedup_keys)
        out[m.name] = edge_output(member_rows, m.src, m.dst)
    return out


def _stack_totals(totals: List[torch.Tensor], device) -> torch.Tensor:
    """Every step's exact requirement in one int64 vector (one host sync)."""
    if not totals:
        return torch.zeros((0,), dtype=torch.int64, device=device)
    return torch.stack([t.to(torch.int64) for t in totals])


def _make_fn(program: UnitProgram, use_kernel: bool, use_bloom: bool):
    """The unit function ``fn(tables)``, returning (outputs, totals).

    Each join step's gather set (:func:`_gather_sets`) is worked out once
    here.  The first call sets ``fn.row_bytes``, each join step's gathered
    :func:`_row_bytes` in ``totals`` order, and
    ``fn.pruned_bytes``, the bytes the steps no longer gather over their
    capacities: static, since the function's cache key holds the input
    schema and the capacities."""
    gathers = _gather_sets(program)
    if program.kind == "merged":
        def run(tables, gathers_iter, totals, widths):
            return _traced_merged(tables, program.unit, program.orders,
                                  iter(program.capacities), gathers_iter,
                                  totals, widths, use_kernel, use_bloom)
    else:
        # views ("query") keep every column — later queries are rewritten
        # over them and may reference any of it; edge units only carry what
        # their conditions and outputs touch
        needed = (_needed_columns_query(program.unit)
                  if program.kind == "edges" else None)

        def run(tables, gathers_iter, totals, widths):
            res, _ = _traced_query(tables, program.unit, program.orders[0],
                                   iter(program.capacities), gathers_iter,
                                   totals, widths, use_kernel, use_bloom,
                                   needed)
            if program.kind == "edges":
                res = edge_output(res, program.unit.src, program.unit.dst)
            return res

    def fn(tables):
        totals: List[torch.Tensor] = []
        widths = [] if fn.row_bytes is None else None
        out = run(tables, iter(gathers), totals, widths)
        if widths is not None:
            fn.row_bytes = tuple(kept for kept, _ in widths)
            fn.pruned_bytes = sum(
                c * (every - kept)
                for c, (kept, every) in zip(program.capacities, widths))
        return out, _stack_totals(totals, next(iter(tables.values())).device)

    fn.row_bytes = None
    fn.pruned_bytes = None
    return fn


# ---------------------------------------------------------------------------
# Compiler / unit cache
# ---------------------------------------------------------------------------

def _schema_fp(inputs: Dict[str, Table]) -> Tuple:
    """Hashable shape+dtype fingerprint of the unit's input tables."""
    return tuple(sorted(
        (name, t.capacity,
         tuple((c, str(t[c].dtype)) for c in t.column_names()))
        for name, t in inputs.items()))


class PipelineCompiler:
    """Builds plan units into cached, overflow-safe unit functions.

    One instance is typically owned by an
    :class:`repro_torch.api.ExtractionEngine`; sharing an instance across
    engines (or passing one explicitly) shares the per-unit capacity memory,
    while the built unit functions live in a process-wide
    content-addressed store.

    ``use_kernel=None`` selects the ``sorted_probe`` CUDA kernel for the
    join probe when ``device`` (default: the CUDA card when there is one)
    is a CUDA device, and the plain bisection on the CPU; ``use_bloom``
    (default: follows ``use_kernel``) additionally prunes probe rows with
    the ``bloom`` semi-join prefilter kernels before each capacity
    expansion.  ``initial_capacity_clamp`` caps the *initial* capacity
    buckets — production code never sets it; tests use it to force the
    overflow-retry branch.
    """

    def __init__(self, margin: float = CAPACITY_MARGIN,
                 use_kernel: Optional[bool] = None,
                 use_bloom: Optional[bool] = None,
                 max_programs: int = 256,
                 max_retries: Optional[int] = None,
                 initial_capacity_clamp: Optional[int] = None,
                 device=None):
        self.margin = float(margin)
        self.use_kernel = resolve_use_kernel(use_kernel, device)
        self.use_bloom = self.use_kernel if use_bloom is None \
            else bool(use_bloom)
        self.max_programs = max_programs
        self.max_retries = max_retries
        self.initial_capacity_clamp = initial_capacity_clamp
        # guards stats and _programs: a shared compiler may serve several
        # engines
        self._lock = threading.Lock()
        self._programs: "collections.OrderedDict" = collections.OrderedDict()
        # stats-independent program memo keyed by (kind, unit): when a
        # unit's stats fingerprint changes, the unit keeps its previously
        # learned join orders and capacities instead of re-estimating —
        # jittering estimates would flip orders and capacity buckets.
        # Overflow-retry still grows capacities when the data truly
        # outgrows them, and updates this memo too.
        self._unit_memo: "collections.OrderedDict" = collections.OrderedDict()
        self.max_unit_memo = 512
        # last observed per-step actual rows, by program signature: the
        # host-side values the overflow check already synced.
        self._last_rows: "collections.OrderedDict" = collections.OrderedDict()
        self.max_last_rows = 512
        self.stats = {"hits": 0, "misses": 0, "retries": 0,
                      "compiled": 0, "compile_s": 0.0,
                      "tiered": 0, "reoptimized": 0}

    _EVENT_METRIC = "pipeline_executable_events_total"

    def _bump(self, key: str, amount=1) -> None:
        with self._lock:
            self.stats[key] += amount
        obs.REGISTRY.counter(
            self._EVENT_METRIC,
            help="Executable-cache and retry events by kind.",
            event=key).inc(amount)

    # -- bookkeeping ---------------------------------------------------------
    def clear(self) -> None:
        """Forget programs and proven capacities (keeps the global
        unit store; see :func:`clear_executable_cache`)."""
        with self._lock:
            self._programs.clear()
            self._unit_memo.clear()

    def _remember_unit(self, kind: str, unit, prog: UnitProgram) -> None:
        with self._lock:
            self._unit_memo[(kind, unit)] = prog
            self._unit_memo.move_to_end((kind, unit))
            while len(self._unit_memo) > self.max_unit_memo:
                self._unit_memo.popitem(last=False)

    def cache_info(self) -> Dict[str, float]:
        with self._lock:
            return {"programs": len(self._programs),
                    "executables": len(_EXECUTABLE_CACHE), **self.stats}

    # -- public execution entry points --------------------------------------
    def run_query(self, db: Database, query: JoinQuery) -> Table:
        """Execute a join query as one unit function (no projection)."""
        return self._run(db, *self._program(db, "query", query))

    def run_query_edges(self, db: Database, query: JoinQuery) -> Table:
        """Execute a query and project it down to its (src, dst) edges."""
        return self._run(db, *self._program(db, "edges", query))

    def run_merged(self, db: Database,
                   merged: MergedQuery) -> Dict[str, Table]:
        """Execute a JS-OJ group; returns {edge label: edge table}."""
        return self._run(db, *self._program(db, "merged", merged))

    # -- internals -----------------------------------------------------------
    def _stats_fp(self, db: Database, inputs: Sequence[str]) -> Tuple:
        return tuple((n, db.stats[n].fingerprint()) for n in inputs)

    def _program(self, db: Database, kind: str, unit):
        with obs.span("pipeline.program", category="plan", detail=True):
            inputs = (_merged_inputs(unit) if kind == "merged"
                      else _query_inputs(unit))
            pkey = (kind, unit, self._stats_fp(db, inputs))
            with self._lock:
                prog = self._programs.get(pkey)
                if prog is not None:
                    self._programs.move_to_end(pkey)
                    return pkey, prog
            with self._lock:
                prog = self._unit_memo.get((kind, unit))
            if prog is None:
                if kind == "merged":
                    prog = build_merged_program(db, unit, self.margin,
                                                self.initial_capacity_clamp)
                else:
                    prog = build_query_program(
                        db, unit, edges=(kind == "edges"), margin=self.margin,
                        clamp=self.initial_capacity_clamp)
                self._remember_unit(kind, unit, prog)
            with self._lock:
                self._programs[pkey] = prog
                while len(self._programs) > self.max_programs:
                    self._programs.popitem(last=False)
        return pkey, prog

    def _executable(self, prog: UnitProgram, inputs: Dict[str, Table]):
        key = (prog.signature, prog.orders, prog.capacities,
               self.use_kernel, self.use_bloom, _schema_fp(inputs))
        with _CACHE_LOCK:
            fn = _EXECUTABLE_CACHE.get(key)
            if fn is not None:
                _EXECUTABLE_CACHE.move_to_end(key)
        if fn is not None:
            self._bump("hits")
            return fn
        t0 = time.perf_counter()
        fn = _make_fn(prog, self.use_kernel, self.use_bloom)
        with _CACHE_LOCK:
            _EXECUTABLE_CACHE[key] = fn
            while len(_EXECUTABLE_CACHE) > _EXECUTABLE_CACHE_SIZE:
                _EXECUTABLE_CACHE.popitem(last=False)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats["misses"] += 1
            self.stats["compile_s"] += dt
            self.stats["compiled"] += 1
        obs.REGISTRY.counter(self._EVENT_METRIC, event="misses").inc()
        obs.TRACER.record(f"pipeline.compile:{prog.kind}", t0, t0 + dt,
                          category="compile", detail=True,
                          capacities=list(prog.capacities), tiered=False)
        return fn

    def _observe_rows(self, prog: UnitProgram, caps: Tuple[int, ...],
                      need: np.ndarray, row_bytes: Tuple[int, ...],
                      pruned_bytes: int, span) -> None:
        """Predicted-vs-actual row accounting (host-known values only).

        ``need`` was already synced by the overflow check, so this adds no
        device round-trips.  The estimate ratio is (actual+1)/(predicted+1)
        — log₂ buckets make under- and over-estimates symmetric around 1.
        ``span`` (the unit's ``pipeline.run``) gets ``slot_bytes``, what the
        join steps gather over their static capacities, ``live_bytes``, the
        part of it that holds rows, and ``pruned_bytes``, what the steps
        would gather besides over the same capacities had none of them
        left a column out (the unit function's).  The per-step
        values are also retained by program signature for
        :meth:`last_rows`.
        """
        if need.size == 0:
            return
        ratio_h = obs.REGISTRY.histogram(
            "pipeline_rows_estimate_ratio",
            help="Actual/predicted rows per join step (1 = perfect "
                 "cost-model estimate).", kind=prog.kind)
        actual = [int(n) for n in need.tolist()]
        for i, n in enumerate(actual):
            if i < len(prog.est_rows):
                ratio_h.observe((n + 1.0) / (prog.est_rows[i] + 1.0))
        if obs.TRACER.enabled:
            span.set(
                live_bytes=sum(n * w for n, w in zip(actual, row_bytes)),
                slot_bytes=sum(c * w for c, w in zip(caps, row_bytes)),
                pruned_bytes=pruned_bytes)
        with self._lock:
            self._last_rows[prog.signature] = {
                "actual": actual,
                "capacities": [int(c) for c in caps],
                "est_rows": [float(r) for r in prog.est_rows],
            }
            self._last_rows.move_to_end(prog.signature)
            while len(self._last_rows) > self.max_last_rows:
                self._last_rows.popitem(last=False)

    def last_rows(self, signature) -> Optional[Dict[str, list]]:
        """Per-step ``{actual, capacities, est_rows}`` from the most recent
        run of the program with this signature, or ``None`` if it never ran
        (or aged out of the bounded retention window).  Pure host memory —
        reading it performs no device work."""
        with self._lock:
            rec = self._last_rows.get(signature)
            return None if rec is None else {k: list(v)
                                             for k, v in rec.items()}

    def peek_program(self, db: Database, kind: str, unit):
        """The program a unit *would* run with — read-only introspection.

        Resolution mirrors :meth:`_program` (stats-keyed programs first,
        then the stats-independent memo with its proven capacities), but a
        miss builds a fresh cost-model program WITHOUT entering it into
        either cache: EXPLAIN over estimated view stats must not pin
        estimate-derived capacities into the memo the execution path will
        later trust.  Returns ``(program, source)`` with source one of
        ``"programs"`` | ``"memo"`` | ``"estimated"``.
        """
        inputs = (_merged_inputs(unit) if kind == "merged"
                  else _query_inputs(unit))
        pkey = (kind, unit, self._stats_fp(db, inputs))
        with self._lock:
            prog = self._programs.get(pkey)
            if prog is not None:
                return prog, "programs"
            prog = self._unit_memo.get((kind, unit))
            if prog is not None:
                return prog, "memo"
        if kind == "merged":
            prog = build_merged_program(db, unit, self.margin,
                                        self.initial_capacity_clamp)
        else:
            prog = build_query_program(db, unit, edges=(kind == "edges"),
                                       margin=self.margin,
                                       clamp=self.initial_capacity_clamp)
        return prog, "estimated"

    def executable_state(self, prog: UnitProgram,
                         tables: Dict[str, Table]) -> str:
        """Would running this program build a unit function or reuse one?

        Nothing is compiled here, so the states mean: ``"cached"`` — the
        built unit function for the exact (signature, orders, capacities,
        kernel flags, input schema) key is in the process-wide unit store;
        ``"uncompiled"`` — it is not, and the first run would build it (a
        host-side closure, no compile); ``"unknown"`` — an input (an
        unmaterialized view) is missing from ``tables``, so the schema part
        of the key cannot be formed without executing.
        """
        if any(n not in tables for n in prog.inputs):
            return "unknown"
        inputs = {n: tables[n] for n in prog.inputs}
        key = (prog.signature, prog.orders, prog.capacities,
               self.use_kernel, self.use_bloom, _schema_fp(inputs))
        with _CACHE_LOCK:
            return "cached" if key in _EXECUTABLE_CACHE else "uncompiled"

    def _run(self, db: Database, pkey, prog: UnitProgram):
        """Execute with overflow-retry; remembers proven capacities.

        One host sync per attempt (the totals vector).  An overflowed step
        re-executes at the pow-2 bucket of its *exact* requirement, which at
        least doubles it; steps downstream of a truncation may only reveal
        their true requirement on the retry, so the loop runs to a fixpoint
        (bounded by the step count — each round fixes at least the first
        overflowing step for good).
        """
        inputs = {n: db.tables[n] for n in prog.inputs}
        caps = prog.capacities
        attempts = self.max_retries
        if attempts is None:
            attempts = max(8, len(caps) + 1)
        for _ in range(attempts + 1):
            cur = dataclasses.replace(prog, capacities=caps)
            fn = self._executable(cur, inputs)
            with obs.span("pipeline.run", category="execute", detail=True,
                          kind=prog.kind) as run_span:
                out, totals = fn(inputs)
            with obs.span("pipeline.sync", category="transfer", detail=True):
                need = totals.cpu().numpy()           # the one host sync
            obs.resolve_device_spans()
            if need.size == 0 or bool(
                    (need <= np.asarray(caps, dtype=np.int64)).all()):
                self._observe_rows(prog, caps, need, fn.row_bytes,
                                   fn.pruned_bytes, run_span)
                if caps != prog.capacities:
                    with self._lock:                  # skip retries next time
                        self._programs[pkey] = cur
                    # stats-independent memo too: future rebuilds of this
                    # unit (new stats fingerprints) start at the proven
                    # capacities instead of re-learning them via retries
                    self._remember_unit(prog.kind, prog.unit, cur)
                return out
            self._bump("retries")
            caps = tuple(
                _round_capacity(int(n)) if int(n) > c else c
                for n, c in zip(need.tolist(), caps))
        raise RuntimeError(
            f"pipeline overflow retry did not converge for "
            f"{prog.signature!r} (capacities {caps})")
