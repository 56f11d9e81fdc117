"""Plan execution against a Database — eager two-phase (count, expand) path.

Every join is the static-shape sort-merge primitive from
:mod:`repro_torch.relational`.  Execution order per query comes from the cost
model's best left-deep order, mirroring the paper's assumption that the base
system picks the join order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost import estimate_query, view_stats_from_estimate
from repro_torch.core.database import Database
from repro_torch.core.jsoj import MergedQuery, shared_query
from repro_torch.core.model import (
    ColumnRef,
    JoinCond,
    JoinQuery,
    Relation,
    join_schedule,
)
from repro_torch.relational import (
    Table,
    dedup,
    filter_table,
    left_outer_join,
    sort_merge_join,
)


def qualified_cond(c: JoinCond, new_alias: str):
    """``(joined-side col, new-side col)`` qualified names for one condition.

    Orients the condition so its left endpoint is on the already-joined
    side and its right endpoint on the relation being joined in.
    """
    cc = c.oriented_from(c.left if c.left != new_alias else c.right)
    return (f"{cc.left}.{cc.lcol}", f"{cc.right}.{cc.rcol}")


def scan_table(t: Table, rel: Relation) -> Table:
    """Filter + alias-prefix one already-loaded table.

    The one definition of scan semantics — the eager executor and the
    compiled pipeline both go through it, which is part of their
    bag-parity contract.
    """
    for f in rel.filters:
        t = filter_table(t, f.col, f.op, f.value)
    return t.prefix(rel.alias)


def scan_relation(db: Database, rel: Relation) -> Table:
    """Load + filter + alias-prefix one base table (or view)."""
    return scan_table(db.table(rel.table), rel)


def execute_query(
    db: Database,
    query: JoinQuery,
    order: Optional[Sequence[str]] = None,
) -> Table:
    """Inner-join a query's relations in cost-model order."""
    if order is None:
        order = estimate_query(db, query).order
    cur = scan_relation(db, query.relation(order[0]))
    for alias, conds, closing in join_schedule(query, order):
        nxt = scan_relation(db, query.relation(alias))
        on = [qualified_cond(c, alias) for c in conds]
        cur = sort_merge_join(cur, nxt, on=on)
        # cycle-closing conditions now fully contained in the joined set
        for c in closing:
            cur = cur.mask(cur[f"{c.left}.{c.lcol}"]
                           == cur[f"{c.right}.{c.rcol}"])
    return cur


def edge_output(table: Table, src: ColumnRef, dst: ColumnRef,
                keep=None) -> Table:
    """Project a query result down to an (src, dst) edge table."""
    valid = table.valid if keep is None else (table.valid & keep)
    return Table(
        columns={"src": table[src.qualified()].to(torch.int32),
                 "dst": table[dst.qualified()].to(torch.int32)},
        valid=valid,
    )


def execute_merged(db: Database, merged: MergedQuery) -> Dict[str, Table]:
    """Execute a JS-OJ merged query; returns {edge label: edge table}.

    Theorem 4.3 recovers each member's result from G_M* by keeping rows where
    all of that member's branch indicators are true.  Because the merged
    table is the *cross product per S-row* of every member's branch matches,
    a member's rows are replicated by the other members' expansions; exact
    bag semantics are restored by deduplicating on (S row id, this member's
    branch match row ids) — those keys identify one original join result row.
    """
    cur = execute_query(db, shared_query(merged))
    cur = cur.with_columns(
        __srow__=torch.arange(cur.capacity, dtype=torch.int32,
                              device=cur.device))
    indicators: Dict[str, str] = {}
    rowid_cols: Dict[str, str] = {}
    for b in merged.branches:
        ind = f"__m__{b.id}"
        indicators[b.id] = ind
        if not b.relations:
            # pure-predicate branch (cyclic closure on S): indicator only
            mask = torch.ones((cur.capacity,), dtype=torch.bool,
                              device=cur.device)
            for c in b.link_conds:
                mask = mask & (cur[f"{c.left}.{c.lcol}"]
                               == cur[f"{c.right}.{c.rcol}"])
            cur = cur.with_columns(**{ind: mask})
            continue
        branch_tbl = execute_query(db, b.as_query()) if len(b.relations) > 1 \
            else scan_relation(db, b.relations[0])
        brow = f"__brow__{b.id}"
        rowid_cols[b.id] = brow
        branch_tbl = branch_tbl.with_columns(
            **{brow: torch.arange(branch_tbl.capacity, dtype=torch.int32,
                                  device=branch_tbl.device)})
        on = [(f"{c.left}.{c.lcol}", f"{c.right}.{c.rcol}")
              for c in b.link_conds]
        cur = left_outer_join(cur, branch_tbl, on=on, indicator=ind)

    out: Dict[str, Table] = {}
    for m in merged.members:
        keep = torch.ones((cur.capacity,), dtype=torch.bool,
                          device=cur.device)
        for bid in m.branch_ids:
            keep = keep & cur[indicators[bid]]
        for c in m.residual_conds:
            keep = keep & (cur[f"{c.left}.{c.lcol}"]
                           == cur[f"{c.right}.{c.rcol}"])
        member_rows = cur.mask(keep)
        dedup_keys = ["__srow__"] + [
            rowid_cols[bid] for bid in m.branch_ids if bid in rowid_cols
        ]
        member_rows = dedup(member_rows, dedup_keys)
        out[m.name] = edge_output(member_rows, m.src, m.dst)
    return out


def materialize_view(db: Database, name: str, query: JoinQuery,
                     stats) -> Table:
    """Execute a view query and register the result under ``name``.

    Column names in the stored view stay pattern-alias-qualified
    ("p0.c_id"), matching the rewrite in :mod:`repro_torch.core.jsmv`.
    """
    result = execute_query(db, query)
    db.add_view(name, result, stats)
    return result


def ensure_view(db: Database, name: str, query: JoinQuery,
                compiler=None) -> bool:
    """Materialize ``name`` (with estimated stats) unless already registered.

    View names are content-addressed (:func:`repro_torch.core.jsmv.view_name`), so
    presence implies the stored table was built from the same canonical
    pattern — an engine cache hit.  Returns True iff the view was built.
    With a :class:`repro_torch.core.pipeline.PipelineCompiler` the view query runs
    as one pre-sized unit function instead of the eager two-phase path.
    """
    if name in db.tables:
        return False
    est = estimate_query(db, query)
    if compiler is None:
        result = execute_query(db, query)
    else:
        result = compiler.run_query(db, query)
    db.add_view(name, result, view_stats_from_estimate(est))
    return True
