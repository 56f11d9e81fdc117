"""Differential evaluation of extraction queries — the IVM join rule.

For a multi-way inner join ``Q = R1 ⋈ … ⋈ Rk`` and per-table signed deltas
``ΔRi = (Ri⁺, Ri⁻)``, the product rule over relation *occurrences* gives

    ΔQ = Σ_i  R1ⁿᵉʷ ⋈ … ⋈ R(i-1)ⁿᵉʷ ⋈ ΔRi ⋈ R(i+1)ᵒˡᵈ ⋈ … ⋈ Rkᵒˡᵈ

(the telescoped form of the classic Δ(R⋈S) = ΔR⋈S ∪ R⋈ΔS ∪ ΔR⋈ΔS —
binding *new* on one side of each term absorbs the ΔΔ cross terms).  Each
term is an ordinary inner equijoin with exactly one (small) delta relation,
so the cost model naturally drives the join order out from the delta and
the whole term runs through the same machinery as a cold extract: the
eager two-phase path or a :class:`repro_torch.core.pipeline.PipelineCompiler`
unit function (on the card: the ``sorted_probe`` and ``bloom`` kernels).  Term queries use canonical versioned table names
(``table#new`` / ``table#old`` / ``table#delta``), so their signatures —
and with pow-2-padded delta tables, their input schemas — repeat across
refreshes and the unit cache serves every refresh after the first.

Signs multiply through a term: the term over ``Ri⁺`` contributes to
``ΔQ⁺``, the term over ``Ri⁻`` to ``ΔQ⁻``.  :func:`apply_table_delta`
then folds ``ΔQ`` into a cached result with plus-before-minus bag
application, which the engine relies on for bit-identical bag digests
against a from-scratch extract.  The fold runs on the host through numpy,
as in the JAX package, and puts the result back on the table's device.
"""
from __future__ import annotations

import dataclasses
from typing import (
    AbstractSet,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from repro_torch.core.database import Database, TableStats, compute_stats
from repro_torch.core.executor import edge_output, execute_query
from repro_torch.core.model import JoinQuery, Relation
from repro_torch.incremental.changelog import MergedDelta
from repro_torch.relational import Table
from repro_torch.relational.join import round_capacity

NEW, OLD, DELTA = "new", "old", "delta"


def versioned_name(table: str, version: str) -> str:
    """Canonical name of one version of a base table inside a term db.

    ``#`` cannot appear in user table names created through the builder,
    and the scheme is deterministic, so term-query signatures are stable
    across refreshes — the unit-cache key contract.
    """
    return f"{table}#{version}"


def split_versioned(name: str) -> Tuple[str, str]:
    base, _, version = name.rpartition("#")
    return base, version


@dataclasses.dataclass(frozen=True)
class DeltaTerm:
    """One summand of the differentiation rule, ready to execute.

    ``query`` is the original query with every relation's table rewritten
    to a versioned name; the relation at ``delta_alias`` reads
    ``table#delta``, which the binding resolves to the plus or the minus
    side according to ``sign``.
    """

    query: JoinQuery
    delta_table: str
    delta_alias: str
    sign: int  # +1 inserts, -1 deletes


def query_delta_terms(
    query: JoinQuery, changed: AbstractSet[str]
) -> List[DeltaTerm]:
    """Differentiate ``query`` w.r.t. every changed relation occurrence."""
    rels = query.relations
    terms: List[DeltaTerm] = []
    for i, rel in enumerate(rels):
        if rel.table not in changed:
            continue
        new_rels = []
        for j, rj in enumerate(rels):
            if j == i:
                version = DELTA
            elif rj.table not in changed:
                version = NEW  # unchanged: old == new, one canonical name
            else:
                version = NEW if j < i else OLD
            new_rels.append(Relation(
                alias=rj.alias,
                table=versioned_name(rj.table, version),
                filters=rj.filters))
        term_query = JoinQuery(
            name=f"{query.name}#d{i}",
            relations=tuple(new_rels),
            conds=query.conds,
            src=query.src,
            dst=query.dst)
        for sign in (1, -1):
            terms.append(DeltaTerm(query=term_query, delta_table=rel.table,
                                   delta_alias=rel.alias, sign=sign))
    return terms


class DeltaPlanner:
    """Rewrites queries into delta form over a set of changed tables."""

    def __init__(self, deltas: Dict[str, MergedDelta]):
        self.deltas = {t: d for t, d in deltas.items() if not d.empty}
        self.changed = frozenset(self.deltas)

    def terms(self, query: JoinQuery) -> List[DeltaTerm]:
        """Non-trivial terms only: a term whose delta side is empty is 0."""
        out = []
        for t in query_delta_terms(query, self.changed):
            d = self.deltas[t.delta_table]
            side = d.plus if t.sign > 0 else d.minus
            if side is not None:
                out.append(t)
        return out


class DeltaExecutor:
    """Evaluates delta terms against versioned table bindings.

    ``old_tables`` / ``old_stats`` describe the base tables as of the
    consumer's changelog cursor (the immutable Table objects it captured);
    ``db`` provides the new state.  With a ``compiler`` each term runs as
    one unit function (pow-2 capacities, overflow retry); without, the
    eager two-phase path.
    """

    def __init__(self, db: Database, old_tables: Dict[str, Table],
                 old_stats: Dict[str, TableStats],
                 deltas: Dict[str, MergedDelta], compiler=None):
        self.db = db
        self.old_tables = old_tables
        self.old_stats = old_stats
        self.planner = DeltaPlanner(deltas)
        self.compiler = compiler
        self._delta_stats: Dict[Tuple[str, int], TableStats] = {}

    def _delta_side(self, term: DeltaTerm) -> Table:
        d = self.planner.deltas[term.delta_table]
        return d.plus if term.sign > 0 else d.minus

    def _delta_stats_for(self, term: DeltaTerm) -> TableStats:
        key = (term.delta_table, term.sign)
        st = self._delta_stats.get(key)
        if st is None:
            st = compute_stats(self._delta_side(term))
            self._delta_stats[key] = st
        return st

    def _term_db(self, term: DeltaTerm) -> Database:
        """Lightweight catalog binding each versioned name to its table."""
        tdb = Database()
        for rel in term.query.relations:
            base, version = split_versioned(rel.table)
            if rel.table in tdb.tables:
                continue
            if version == DELTA:
                tdb.tables[rel.table] = self._delta_side(term)
                tdb.stats[rel.table] = self._delta_stats_for(term)
            elif version == OLD:
                tdb.tables[rel.table] = self.old_tables[base]
                tdb.stats[rel.table] = self.old_stats[base]
            else:
                tdb.tables[rel.table] = self.db.tables[base]
                tdb.stats[rel.table] = self.db.stats[base]
        return tdb

    def query_delta(
        self, query: JoinQuery, edges: bool = True
    ) -> Tuple[List[Table], List[Table]]:
        """(ΔQ⁺ parts, ΔQ⁻ parts) for one query.

        ``edges=True`` projects each part down to its (src, dst) edge
        table (edge maintenance); ``edges=False`` keeps every column
        (JS-MV view maintenance).
        """
        from repro_torch import obs

        plus: List[Table] = []
        minus: List[Table] = []
        terms = self.planner.terms(query)
        for term in terms:
            sign = "plus" if term.sign > 0 else "minus"
            # delta-side size is host metadata (pow-2 padded capacity of
            # the folded changelog rows) — no device sync to report it
            delta_cap = self._delta_side(term).capacity
            with obs.span(f"delta:{term.query.name}", category="execute",
                          detail=True, sign=sign, delta_rows=delta_cap):
                tdb = self._term_db(term)
                if self.compiler is not None:
                    if edges:
                        out = self.compiler.run_query_edges(tdb, term.query)
                    else:
                        out = self.compiler.run_query(tdb, term.query)
                else:
                    out = execute_query(tdb, term.query)
                    if edges:
                        out = edge_output(out, term.query.src,
                                          term.query.dst)
            obs.REGISTRY.histogram(
                "delta_term_rows",
                help="Delta-side capacity per differentiated term.",
                sign=sign).observe(delta_cap)
            (plus if term.sign > 0 else minus).append(out)
        obs.REGISTRY.counter(
            "delta_terms_total",
            help="Non-trivial IVM terms executed.").inc(len(terms))
        return plus, minus


def apply_table_delta(
    table: Table,
    plus_parts: Sequence[Table],
    minus_parts: Sequence[Table],
    capacity: Optional[int] = None,
) -> Table:
    """Fold a signed delta into a cached table; returns the new table.

    Plus rows are appended *before* minus rows cancel (a row inserted and
    deleted within the window must annihilate), then the result is
    host-compacted to a pow-2 capacity bucket of its live rows — repeated
    refreshes keep stable shapes for downstream unit functions, and
    padding garbage never accumulates across refreshes.
    """
    from repro_torch.relational import bag_cancel_mask

    datas = [table.to_numpy()] + [p.to_numpy() for p in plus_parts]
    names = sorted(datas[0])
    cols = {n: np.concatenate([d[n] for d in datas]) for n in names}
    n_rows = len(cols[names[0]])
    if minus_parts and n_rows:
        minus_data = [m.to_numpy() for m in minus_parts]
        mcols = {n: np.concatenate([d[n] for d in minus_data]) for n in names}
        if len(mcols[names[0]]):
            keep = bag_cancel_mask(
                [cols[n] for n in names], np.ones(n_rows, dtype=bool),
                [mcols[n] for n in names])
            if not keep.all():
                cols = {n: c[keep] for n, c in cols.items()}
                n_rows = int(keep.sum())
    cap = capacity if capacity is not None else round_capacity(n_rows)
    return Table.from_arrays(capacity=cap, device=table.device, **cols)
