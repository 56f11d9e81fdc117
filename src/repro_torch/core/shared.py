"""Shared-subgraph detection (Definition 4.2).

A *shared pattern* is a connected join subgraph (tables + equality
conditions + pushed filters, aliases abstracted away) that embeds into two
or more places across the edge-definition queries — or twice into the same
query (e.g. C |><| SS appears twice inside Co-pur).  The paper finds these by
exhaustive search and argues join graphs are small enough for that to be
trivial; we do the same: enumerate all connected condition subsets of every
query, canonicalize, and match by backtracking.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Sequence, Tuple

from repro_torch.core.model import (
    JoinCond,
    JoinQuery,
    Relation,
    Signature,
    pattern_signature,
)

MAX_PATTERN_CONDS = 4  # exhaustive-search bound; paper workloads use <= 2


@dataclasses.dataclass(frozen=True)
class SharedPattern:
    """Connected join pattern with canonical aliases ``p0..pk``."""

    relations: Tuple[Relation, ...]
    conds: Tuple[JoinCond, ...]
    signature: Signature

    @property
    def num_conds(self) -> int:
        return len(self.conds)

    def alias_for_table_role(self) -> Dict[str, str]:
        return {r.alias: r.table for r in self.relations}


@dataclasses.dataclass(frozen=True)
class Embedding:
    """One occurrence of a pattern inside a query."""

    alias_map: Dict[str, str]          # pattern alias -> query alias
    used_conds: FrozenSet[int]         # indices into query.conds

    def mapped_aliases(self) -> FrozenSet[str]:
        return frozenset(self.alias_map.values())

    def key(self) -> Tuple:
        return (tuple(sorted(self.alias_map.items())), self.used_conds)


def _cond_compatible(
    pc: JoinCond,
    p_tables: Dict[str, Relation],
    qc: JoinCond,
    q_tables: Dict[str, Relation],
):
    """Yield orientation mappings {p_alias: q_alias} if qc can realize pc."""
    for q in (qc, qc.flipped()):
        pl, ql = p_tables[pc.left], q_tables[q.left]
        pr, qr = p_tables[pc.right], q_tables[q.right]
        if (
            pl.table == ql.table
            and pr.table == qr.table
            and pl.filters == ql.filters
            and pr.filters == qr.filters
            and pc.lcol == q.lcol
            and pc.rcol == q.rcol
        ):
            yield {pc.left: q.left, pc.right: q.right}


def find_embeddings(pattern: SharedPattern, query: JoinQuery) -> List[Embedding]:
    """All embeddings of ``pattern`` in ``query`` (backtracking search)."""
    p_tables = {r.alias: r for r in pattern.relations}
    q_tables = {r.alias: r for r in query.relations}

    # order pattern conds so each one touches an already-bound alias
    conds = list(pattern.conds)
    ordered: List[JoinCond] = [conds.pop(0)]
    bound = set(ordered[0].endpoints())
    while conds:
        for i, c in enumerate(conds):
            if c.left in bound or c.right in bound:
                ordered.append(conds.pop(i))
                bound |= c.endpoints()
                break
        else:  # disconnected pattern (should not happen)
            ordered.append(conds.pop(0))
            bound |= ordered[-1].endpoints()

    results: List[Embedding] = []
    seen = set()

    def backtrack(idx: int, amap: Dict[str, str], used: FrozenSet[int]):
        if idx == len(ordered):
            emb = Embedding(dict(amap), used)
            k = emb.key()
            if k not in seen:
                seen.add(k)
                results.append(emb)
            return
        pc = ordered[idx]
        for qi, qc in enumerate(query.conds):
            if qi in used:
                continue
            for orient in _cond_compatible(pc, p_tables, qc, q_tables):
                new_map = dict(amap)
                ok = True
                for pa, qa in orient.items():
                    if pa in new_map:
                        if new_map[pa] != qa:
                            ok = False
                            break
                    elif qa in new_map.values():
                        ok = False  # injectivity
                        break
                    else:
                        new_map[pa] = qa
                if ok:
                    backtrack(idx + 1, new_map, used | {qi})

    backtrack(0, {}, frozenset())
    return results


def _connected_cond_subsets(query: JoinQuery) -> List[Tuple[int, ...]]:
    """All connected subsets of condition indices up to MAX_PATTERN_CONDS."""
    n = len(query.conds)
    found = set()
    frontier = [frozenset([i]) for i in range(n)]
    for s in frontier:
        found.add(s)
    while frontier:
        nxt = []
        for s in frontier:
            if len(s) >= MAX_PATTERN_CONDS:
                continue
            aliases = set()
            for i in s:
                aliases |= query.conds[i].endpoints()
            for j in range(n):
                if j in s:
                    continue
                c = query.conds[j]
                if c.left in aliases or c.right in aliases:
                    t = s | {j}
                    if t not in found:
                        found.add(t)
                        nxt.append(t)
        frontier = nxt
    return [tuple(sorted(s)) for s in sorted(found, key=lambda s: (len(s), sorted(s)))]


def subgraph_pattern(query: JoinQuery, cond_idx: Sequence[int]) -> SharedPattern:
    """Canonicalize the subgraph spanned by ``cond_idx`` into a pattern."""
    conds = [query.conds[i] for i in cond_idx]
    aliases = sorted({a for c in conds for a in c.endpoints()})
    rels = [query.relation(a) for a in aliases]
    sig = pattern_signature(rels, conds)
    # rebuild canonical relations/conds from the signature
    tables, sig_conds = sig
    crels = tuple(
        Relation(alias=f"p{i}", table=t, filters=f)
        for i, (t, f) in enumerate(tables)
    )
    cconds = tuple(
        JoinCond(a[0], a[1], b[0], b[1]) for a, b in sig_conds
    )
    return SharedPattern(relations=crels, conds=cconds, signature=sig)


def enumerate_shared_patterns(
    queries: Sequence[JoinQuery],
) -> List[Tuple[SharedPattern, Dict[str, List[Embedding]]]]:
    """All patterns with >=2 embeddings across (or within) the given queries.

    Returns (pattern, {query_name: embeddings}) sorted by descending pattern
    size then total use count, so planners see big/most-shared candidates
    first.
    """
    by_sig: Dict[Signature, SharedPattern] = {}
    for q in queries:
        for subset in _connected_cond_subsets(q):
            p = subgraph_pattern(q, subset)
            by_sig.setdefault(p.signature, p)

    out = []
    for sig, pattern in by_sig.items():
        embs: Dict[str, List[Embedding]] = {}
        total = 0
        for q in queries:
            e = find_embeddings(pattern, q)
            if e:
                embs[q.name] = e
                # automorphic embeddings share a condition footprint and are
                # ONE occurrence (a palindromic query must not count as
                # "sharing with itself")
                total += len({emb.used_conds for emb in e})
        if total >= 2:
            out.append((pattern, embs))
    out.sort(
        key=lambda pe: (
            -pe[0].num_conds,
            -sum(len(v) for v in pe[1].values()),
            pe[0].signature,
        )
    )
    return out
