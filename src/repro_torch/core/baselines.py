"""Join-workload baselines: GraphGen and R2GSync (Section 2.3).

Both decompose edge-definition queries into *virtual edges*, materialize
those, and then pay a **conversion** step (joining the virtual-edge tables
back together) to produce the user-intended graph — the cost the paper
reports in parentheses.  Faithful modelling choices:

* **R2GSync** decomposes at *every* join: each condition becomes one
  materialized binary virtual-edge table.  Identical virtual edges are
  materialized once (their synchronization benefit).
* **GraphGen** decomposes *chain* queries at their midpoint hub (Figure 3(b):
  Co-pur becomes 2-hop paths through virtual item vertices, i.e. one
  materialized C|><|SS|><|I half reused for both hops).  Mirrored halves
  share one materialization via pattern-canonical dedup.
* Neither supports star/cyclic queries (§2.3): those run Ringo-style — full
  query, no conversion — matching the paper's fraud-scenario description.

Materialized pieces are stored with *pattern-canonical* column names
("p0.c_id"), so one piece serves every embedding (e.g. both mirrored halves
of a palindromic chain); each use renames through its own embedding.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

from repro_torch.core.database import Database
from repro_torch.core.executor import edge_output, execute_query
from repro_torch.core.model import ColumnRef, JoinQuery
from repro_torch.core.shared import find_embeddings, subgraph_pattern
from repro_torch.relational import Table, sort_merge_join


def _ready(t: Table) -> None:
    """Wait for the device work producing ``t`` (no-op on the CPU), so the
    extract/convert split times finished work."""
    from repro_torch.core.extract import synchronize_tables

    synchronize_tables([t])


def _subchain_query(query: JoinQuery, aliases: List[str]) -> JoinQuery:
    """The query restricted to a contiguous alias run of a chain."""
    aset = set(aliases)
    rels = tuple(query.relation(a) for a in aliases)
    conds = tuple(c for c in query.conds
                  if c.left in aset and c.right in aset)
    return JoinQuery(
        name="__piece__", relations=rels, conds=conds,
        src=ColumnRef(aliases[0], "__any__"),
        dst=ColumnRef(aliases[0], "__any__"),
    )


class _PieceStore:
    """Materialized virtual-edge pieces, deduped by canonical pattern."""

    def __init__(self, db: Database):
        self.db = db
        self.pieces: Dict = {}   # signature -> (pattern, canonical Table)

    def get(self, query: JoinQuery, aliases: List[str]):
        """Materialize (or fetch) the piece; return (pattern, table, q->p map)."""
        piece_q = _subchain_query(query, aliases)
        idx = list(range(len(piece_q.conds)))
        pattern = subgraph_pattern(piece_q, idx)
        sig = pattern.signature
        if sig not in self.pieces:
            result = execute_query(self.db, piece_q)
            emb = find_embeddings(pattern, piece_q)[0]
            rename = {}
            for p_alias, q_alias in emb.alias_map.items():
                for col in self.db.table(query.relation(q_alias).table):
                    rename[f"{q_alias}.{col}"] = f"{p_alias}.{col}"
            canon = result.rename(
                {c: rename[c] for c in result.column_names()})
            _ready(canon)
            self.pieces[sig] = (pattern, canon)
        pattern, canon = self.pieces[sig]
        emb = find_embeddings(pattern, piece_q)[0]
        inv = {q: p for p, q in emb.alias_map.items()}
        return pattern, canon, inv


def _chain_for(q: JoinQuery) -> List[str]:
    order = q.chain_order()
    if order[0] != q.src.alias:
        order = order[::-1]
    return order


def _alias_key_col(db: Database, q: JoinQuery, alias: str) -> str:
    """Row identity of ``alias`` for re-assembling virtual edges.

    Two hops sharing a relation must be re-joined on the same *tuple*, not
    merely on one key column (a fact table's o_sk is not unique per row).
    All base tables carry an explicit ``rid`` tuple id; fall back to a join
    key column only for tables without one.
    """
    if "rid" in db.table(q.relation(alias).table):
        return "rid"
    for c in q.conds:
        if c.left == alias:
            return c.lcol
        if c.right == alias:
            return c.rcol
    raise ValueError(f"{alias} has no conditions")


def run_graphgen(
    db: Database, queries: List[JoinQuery]
) -> Tuple[Dict[str, Table], float, float]:
    """GraphGen: midpoint decomposition of chains + conversion join."""
    t0 = time.perf_counter()
    store = _PieceStore(db)
    chain_plan: Dict[str, Tuple] = {}
    edges: Dict[str, Table] = {}

    for q in queries:
        if not q.is_chain() or len(q.relations) < 4:
            res = execute_query(db, q)         # star/cyclic: no decomposition
            edges[q.name] = edge_output(res, q.src, q.dst)
            _ready(edges[q.name])
            continue
        order = _chain_for(q)
        mid = len(order) // 2
        halves = []
        for aliases in (order[: mid + 1], order[mid:]):
            halves.append((aliases,) + store.get(q, aliases)[1:])
        chain_plan[q.name] = (q, order[mid], halves)
    extract_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for name, (q, hub, halves) in chain_plan.items():
        (al_l, tbl_l, inv_l), (al_r, tbl_r, inv_r) = halves
        hub_col = _alias_key_col(db, q, hub)
        left = tbl_l.rename({c: f"L::{c}" for c in tbl_l.column_names()})
        right = tbl_r.rename({c: f"R::{c}" for c in tbl_r.column_names()})
        joined = sort_merge_join(
            left, right,
            on=[(f"L::{inv_l[hub]}.{hub_col}", f"R::{inv_r[hub]}.{hub_col}")],
        )
        src = f"L::{inv_l[q.src.alias]}.{q.src.col}"
        dst = f"R::{inv_r[q.dst.alias]}.{q.dst.col}"
        edges[name] = Table(
            columns={"src": joined[src], "dst": joined[dst]},
            valid=joined.valid)
        _ready(edges[name])
    convert_s = time.perf_counter() - t0
    return edges, extract_s, convert_s


def run_r2gsync(
    db: Database, queries: List[JoinQuery]
) -> Tuple[Dict[str, Table], float, float]:
    """R2GSync: every join becomes one synchronized virtual-edge table."""
    t0 = time.perf_counter()
    store = _PieceStore(db)
    plans: Dict[str, Tuple] = {}
    edges: Dict[str, Table] = {}

    for q in queries:
        if not q.is_chain():
            res = execute_query(db, q)
            edges[q.name] = edge_output(res, q.src, q.dst)
            _ready(edges[q.name])
            continue
        order = _chain_for(q)
        hops = []
        for i in range(len(order) - 1):
            pair = [order[i], order[i + 1]]
            hops.append((pair,) + store.get(q, pair)[1:])
        plans[q.name] = (q, order, hops)
    extract_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for name, (q, order, hops) in plans.items():
        pair0, tbl0, inv0 = hops[0]
        cur = tbl0.rename({c: f"h0::{c}" for c in tbl0.column_names()})
        prev_inv = inv0
        for hi, (pair, tbl, inv) in enumerate(hops[1:], start=1):
            nxt = tbl.rename({c: f"h{hi}::{c}" for c in tbl.column_names()})
            shared = pair[0]                    # previous hop's right end
            key = _alias_key_col(db, q, shared)
            cur = sort_merge_join(
                cur, nxt,
                on=[(f"h{hi-1}::{prev_inv[shared]}.{key}",
                     f"h{hi}::{inv[shared]}.{key}")],
            )
            prev_inv = inv
        src = f"h0::{inv0[q.src.alias]}.{q.src.col}"
        last_pair, _, last_inv = hops[-1]
        dst = f"h{len(hops)-1}::{last_inv[q.dst.alias]}.{q.dst.col}"
        edges[name] = Table(
            columns={"src": cur[src], "dst": cur[dst]}, valid=cur.valid)
        _ready(edges[name])
    convert_s = time.perf_counter() - t0
    return edges, extract_s, convert_s
