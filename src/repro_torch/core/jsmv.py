"""JS-MV — join sharing by materialized view (Section 4.2).

A view materializes a shared pattern once; every embedding of that pattern
in a query is replaced by a single view relation (Figure 9(b):
Co-pur = V1 |><| I |><| V2 after materializing V = C |><| SS).

View tables keep pattern-alias-qualified column names ("p0.c_id"), so a
rewritten condition that used to reference a replaced alias now references
the view column "<p_alias>.<col>" through the view relation.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.model import ColumnRef, JoinCond, JoinQuery, Relation
from repro_torch.core.shared import Embedding, SharedPattern, find_embeddings


def view_name(pattern: SharedPattern) -> str:
    """Content-addressed view name, stable across plans and requests.

    Two plans that materialize the same canonical pattern produce the same
    name, which is what lets the engine's view cache satisfy a plan cached
    before the view existed (the cached plan's view names resolve against
    the cache by construction).  The ``view_`` prefix doubles as the
    no-views-of-views guard in the planner.
    """
    digest = hashlib.md5(repr(pattern.signature).encode()).hexdigest()
    return f"view_{digest[:10]}"


@dataclasses.dataclass(frozen=True)
class ViewDef:
    name: str
    pattern: SharedPattern

    def base_tables(self) -> Tuple[str, ...]:
        """Base tables the pattern reads — the view's maintenance scope.

        A view is affected by exactly these tables' deltas: incremental
        maintenance differentiates :meth:`as_query` w.r.t. them, and
        eviction checks compare only their stats fingerprints.
        """
        return tuple(sorted({r.table for r in self.pattern.relations}))

    def as_query(self) -> JoinQuery:
        return JoinQuery(
            name=self.name,
            relations=self.pattern.relations,
            conds=self.pattern.conds,
            src=ColumnRef(self.pattern.relations[0].alias, "__any__"),
            dst=ColumnRef(self.pattern.relations[0].alias, "__any__"),
        )


def select_disjoint(embs: Sequence[Embedding]) -> List[Embedding]:
    """Greedy maximal set of alias- and cond-disjoint embeddings."""
    chosen: List[Embedding] = []
    used_aliases: set = set()
    used_conds: set = set()
    for e in sorted(embs, key=lambda e: sorted(e.used_conds)):
        if e.mapped_aliases() & used_aliases:
            continue
        if e.used_conds & used_conds:
            continue
        chosen.append(e)
        used_aliases |= e.mapped_aliases()
        used_conds |= set(e.used_conds)
    return chosen


def rewrite_query(
    query: JoinQuery, view: ViewDef,
    embeddings: Optional[Sequence[Embedding]] = None,
) -> Tuple[JoinQuery, int]:
    """Replace disjoint embeddings of ``view.pattern`` with view relations.

    Returns (rewritten query, number of replacements); 0 means unchanged.
    """
    embs = embeddings
    if embs is None:
        cands = find_embeddings(view.pattern, query)
        # an embedding is only rewritable if no NON-pattern condition has
        # both endpoints inside it (that would become an inexpressible
        # self-condition on the view relation)
        def rewritable(e: Embedding) -> bool:
            mapped = e.mapped_aliases()
            for i, c in enumerate(query.conds):
                if i in e.used_conds:
                    continue
                if c.left in mapped and c.right in mapped:
                    return False
            return True
        embs = select_disjoint([e for e in cands if rewritable(e)])
    if not embs:
        return query, 0

    # map replaced query alias -> (view relation alias, pattern alias)
    replaced: Dict[str, Tuple[str, str]] = {}
    removed_conds: set = set()
    new_relations: List[Relation] = []
    for vi, emb in enumerate(embs):
        v_alias = f"{query.name}__{view.name}_{vi}"
        for p_alias, q_alias in emb.alias_map.items():
            replaced[q_alias] = (v_alias, p_alias)
        removed_conds |= set(emb.used_conds)
        new_relations.append(Relation(alias=v_alias, table=view.name))

    kept_relations = [r for r in query.relations if r.alias not in replaced]

    def remap_end(alias: str, col: str) -> Tuple[str, str]:
        if alias in replaced:
            v_alias, p_alias = replaced[alias]
            return v_alias, f"{p_alias}.{col}"
        return alias, col

    new_conds: List[JoinCond] = []
    for i, c in enumerate(query.conds):
        if i in removed_conds:
            continue
        la, lc = remap_end(c.left, c.lcol)
        ra, rc = remap_end(c.right, c.rcol)
        assert la != ra, "self-condition should have been excluded"
        new_conds.append(JoinCond(la, lc, ra, rc))

    sa, sc = remap_end(query.src.alias, query.src.col)
    da, dc = remap_end(query.dst.alias, query.dst.col)
    out = JoinQuery(
        name=query.name,
        relations=tuple(kept_relations + new_relations),
        conds=tuple(new_conds),
        src=ColumnRef(sa, sc),
        dst=ColumnRef(da, dc),
    )
    return out, len(embs)
