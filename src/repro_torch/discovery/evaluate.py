"""Honest evaluation: strip FK-name hints, score recovery vs hand models.

``anonymize_columns`` renames every column to ``col<j>`` (per table, in
sorted order) so nothing in the schema says which column references which
— discovery has to earn its FKs from profiles and containment alone.
``rename_query`` maps a hand-written query through the same renaming so
its alias-independent :func:`query_signature` can be compared against
discovered edge candidates, and ``edge_recovery`` /
``precision_recall`` turn that into recall and precision numbers.

Scoring is *equivalence-aware*: the synthetic dims carry a surrogate
``rid`` that is bit-identical to the id column, and no data-driven method
(names stripped) can tell identical columns apart — nor does it matter,
since joining on either produces bit-identical edge tables.
:func:`column_equivalence` groups same-content columns and both sides of
every comparison are canonicalized to the class representative first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.database import Database
from repro_torch.core.model import ColumnRef, GraphModel, JoinCond, JoinQuery
from repro_torch.discovery.infer import JoinKeyCandidate
from repro_torch.discovery.synthesize import EdgeCandidate
from repro_torch.relational.table import host

ColKey = Tuple[str, str]                 # (table, column)
Pair = FrozenSet[ColKey]                 # unordered join-column pair


def anonymize_columns(db: Database
                      ) -> Tuple[Database, Dict[ColKey, str]]:
    """A copy of ``db`` with every column renamed to ``col<j>``.

    Table names survive (they are labels, not join hints); the returned
    mapping ``(table, original_col) -> anonymized_col`` lets ground truth
    follow the renaming.
    """
    new = Database()
    mapping: Dict[ColKey, str] = {}
    for name in sorted(db.tables):
        t = db.tables[name]
        ren = {c: f"col{j}" for j, c in enumerate(t.column_names())}
        mapping.update({(name, c): r for c, r in ren.items()})
        new.add_table(name, t.rename(ren))
    return new, mapping


def rename_query(query: JoinQuery,
                 mapping: Dict[ColKey, str]) -> JoinQuery:
    """The same query phrased over anonymized column names."""
    tbl = {r.alias: r.table for r in query.relations}

    def col(alias: str, c: str) -> str:
        return mapping[(tbl[alias], c)]

    relations = tuple(
        dataclasses.replace(
            r, filters=tuple(dataclasses.replace(
                f, col=mapping[(r.table, f.col)]) for f in r.filters))
        for r in query.relations)
    conds = tuple(JoinCond(c.left, col(c.left, c.lcol),
                           c.right, col(c.right, c.rcol))
                  for c in query.conds)
    return dataclasses.replace(
        query, relations=relations, conds=conds,
        src=ColumnRef(query.src.alias, col(query.src.alias, query.src.col)),
        dst=ColumnRef(query.dst.alias, col(query.dst.alias, query.dst.col)))


def column_equivalence(db: Database) -> Dict[ColKey, str]:
    """Map each (table, col) to the representative of its identical-content
    class (columns whose valid-row values are bit-identical).

    Joining on any member of a class yields the same rows, so discovery
    picking ``rid`` where the hand model says ``v_id`` (identical arrays in
    the synthetic dims) is the same answer, not an error.  One host copy
    of each column, compared as raw bytes.
    """
    rep: Dict[ColKey, str] = {}
    for name in sorted(db.tables):
        t = db.tables[name]
        valid = host(t.valid)
        groups: Dict[tuple, List[str]] = {}
        for c in t.column_names():
            arr = host(t[c])[valid]
            groups.setdefault((arr.dtype.str, arr.tobytes()), []).append(c)
        for cols in groups.values():
            head = sorted(cols)[0]
            for c in cols:
                rep[(name, c)] = head
    return rep


def canonicalize_pairs(pairs: Iterable[Pair],
                       equiv: Dict[ColKey, str]) -> FrozenSet[Pair]:
    """Rewrite every pair's columns to their equivalence representative."""
    return frozenset(
        frozenset((t, equiv.get((t, c), c)) for t, c in pair)
        for pair in pairs)


def model_fk_pairs(models: Iterable[GraphModel],
                   mapping: Optional[Dict[ColKey, str]] = None
                   ) -> FrozenSet[Pair]:
    """Ground-truth join pairs: every distinct (table.col, table.col)
    equality used by the hand-written models, direction-insensitive."""
    pairs = set()
    for m in models:
        for q in m.queries():
            tbl = {r.alias: r.table for r in q.relations}
            for c in q.conds:
                a = (tbl[c.left], c.lcol)
                b = (tbl[c.right], c.rcol)
                if mapping is not None:
                    a = (a[0], mapping[a])
                    b = (b[0], mapping[b])
                pairs.add(frozenset((a, b)))
    return frozenset(pairs)


def fk_pairs(fks: Iterable[JoinKeyCandidate]) -> FrozenSet[Pair]:
    """Discovered FKs as direction-insensitive join pairs."""
    return frozenset(
        frozenset(((c.child_table, c.child_col),
                   (c.parent_table, c.parent_col)))
        for c in fks)


def precision_recall(predicted: FrozenSet[Pair],
                     truth: FrozenSet[Pair]) -> Tuple[float, float]:
    if not predicted:
        return (1.0 if not truth else 0.0), (1.0 if not truth else 0.0)
    tp = len(predicted & truth)
    precision = tp / len(predicted)
    recall = tp / len(truth) if truth else 1.0
    return precision, recall


def edge_recovery(hand_queries: Sequence[JoinQuery],
                  edges: Sequence[EdgeCandidate],
                  mapping: Optional[Dict[ColKey, str]] = None,
                  equiv: Optional[Dict[ColKey, str]] = None,
                  top: Optional[int] = None) -> Dict[str, object]:
    """Which hand-written edge queries appear among the ranked candidates.

    Matching is by alias-independent :func:`query_signature` (same tables,
    join conditions, and src/dst output columns), with both sides
    canonicalized through ``equiv`` when given.  Returns per-edge ranks
    (1-based position in the candidate ranking) and the recall over the
    ``top`` slice (default: all candidates).
    """
    from repro_torch.core.model import query_signature

    ranked = edges if top is None else list(edges)[:top]
    sig_rank = {}
    for i, e in enumerate(ranked):
        q = rename_query(e.query, equiv) if equiv is not None else e.query
        sig_rank.setdefault(query_signature(q), i + 1)
    recovered: Dict[str, int] = {}
    missing: List[str] = []
    for q in hand_queries:
        target = rename_query(q, mapping) if mapping is not None else q
        if equiv is not None:
            target = rename_query(target, equiv)
        rank = sig_rank.get(query_signature(target))
        if rank is None:
            missing.append(q.name)
        else:
            recovered[q.name] = rank
    total = len(hand_queries)
    return {
        "recovered": recovered,
        "missing": missing,
        "recall": (len(recovered) / total) if total else 1.0,
        "worst_rank": max(recovered.values()) if recovered else 0,
        "candidates": len(ranked),
    }
