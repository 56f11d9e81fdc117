"""JS-OJ — join sharing by outer join (Section 4.1, Algorithm 1).

A :class:`MergedQuery` is the join graph of Figure 8: one shared subgraph S
(inner joins) with every member query's non-shared subgraphs attached as
LEFT OUTER branches.  The outer table is always inside S (the paper's rule),
so branches cannot interfere (Theorem 4.3); each member's edge rows are the
merged rows where all of that member's branch indicators are true.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost import (
    A_D,
    C_BUILD,
    C_FIXED,
    C_OUT,
    C_PROBE,
    QueryEstimate,
    estimate_query,
)
from repro_torch.core.database import Database
from repro_torch.core.model import ColumnRef, JoinCond, JoinQuery, Relation
from repro_torch.core.shared import Embedding, SharedPattern


@dataclasses.dataclass(frozen=True)
class Branch:
    """One non-shared subgraph u_{i,j}, outer-attached to S."""

    id: str
    origin: str                              # member query name
    relations: Tuple[Relation, ...]          # renamed "<origin>__<alias>"
    inner_conds: Tuple[JoinCond, ...]
    link_conds: Tuple[JoinCond, ...]         # left side = pattern alias (S)

    def as_query(self) -> JoinQuery:
        """The branch as a standalone inner-join query (for execution/cost)."""
        ref = ColumnRef(self.relations[0].alias,
                        "")  # placeholder; branches have no src/dst
        return JoinQuery(
            name=self.id,
            relations=self.relations,
            conds=self.inner_conds,
            src=dataclasses.replace(ref, col=_any_col(self.relations[0])),
            dst=dataclasses.replace(ref, col=_any_col(self.relations[0])),
        )


def _any_col(rel: Relation) -> str:
    # src/dst of a branch query are never used; JoinQuery just needs a valid ref
    return "__any__"


@dataclasses.dataclass(frozen=True)
class MemberOutput:
    """How to recover one original edge query from the merged result."""

    name: str
    src: ColumnRef                           # merged-space reference
    dst: ColumnRef
    branch_ids: Tuple[str, ...]
    residual_conds: Tuple[JoinCond, ...]     # S-internal conds not in pattern


@dataclasses.dataclass(frozen=True)
class MergedQuery:
    """G_M* of Algorithm 1 for a group of member queries."""

    pattern: SharedPattern
    branches: Tuple[Branch, ...]
    members: Tuple[MemberOutput, ...]

    def member_names(self) -> Tuple[str, ...]:
        return tuple(m.name for m in self.members)


def shared_query(merged: MergedQuery) -> JoinQuery:
    """The shared subgraph S as a standalone inner-join query.

    Used identically by the cost model, the eager executor, and the
    compiled pipeline — S's src/dst refs are placeholders (branch merging
    happens before any edge projection).
    """
    return JoinQuery(
        name="__S__",
        relations=merged.pattern.relations,
        conds=merged.pattern.conds,
        src=ColumnRef(merged.pattern.relations[0].alias, "__any__"),
        dst=ColumnRef(merged.pattern.relations[0].alias, "__any__"),
    )


def merge_queries(
    pattern: SharedPattern,
    members: Sequence[Tuple[JoinQuery, Embedding]],
) -> MergedQuery:
    """Algorithm 1 lines 6-20 for one decomposition choice.

    ``members`` gives, per original query, the embedding that identifies its
    copy of the shared subgraph S with the pattern aliases.
    """
    branches: List[Branch] = []
    outs: List[MemberOutput] = []
    for query, emb in members:
        inv = {qa: pa for pa, qa in emb.alias_map.items()}
        shared_aliases = set(inv)
        non_shared = [a for a in query.aliases() if a not in shared_aliases]
        comps = query.connected_components(non_shared)

        def rename(alias: str) -> str:
            return f"{query.name}__{alias}"

        member_branch_ids = []
        for ci, comp in enumerate(sorted(comps, key=sorted)):
            bid = f"{query.name}__u{ci}"
            rels = tuple(
                dataclasses.replace(query.relation(a), alias=rename(a))
                for a in sorted(comp)
            )
            inner, links = [], []
            for c in query.conds:
                lin, rin = c.left in comp, c.right in comp
                if lin and rin:
                    inner.append(JoinCond(rename(c.left), c.lcol,
                                          rename(c.right), c.rcol))
                elif lin or rin:
                    cc = c.oriented_from(c.right if lin else c.left)
                    # now cc.left is the non-component endpoint
                    if cc.left in shared_aliases:
                        links.append(JoinCond(inv[cc.left], cc.lcol,
                                              rename(cc.right), cc.rcol))
                    # conds to OTHER components cannot exist (components are
                    # maximal), so anything else would be a bug:
                    elif cc.left not in shared_aliases:
                        raise AssertionError(
                            f"cond {c} crosses two non-shared components")
            branches.append(Branch(
                id=bid, origin=query.name, relations=rels,
                inner_conds=tuple(inner), link_conds=tuple(links),
            ))
            member_branch_ids.append(bid)

        # S-internal conds of this member that are NOT pattern conds act as
        # per-member filters on S (cyclic queries); they must not filter other
        # members, so they become indicator predicates, not S filters.
        residual = []
        for i, c in enumerate(query.conds):
            if i in emb.used_conds:
                continue
            if c.left in shared_aliases and c.right in shared_aliases:
                residual.append(JoinCond(inv[c.left], c.lcol,
                                         inv[c.right], c.rcol))

        def remap_ref(ref: ColumnRef) -> ColumnRef:
            if ref.alias in shared_aliases:
                return ColumnRef(inv[ref.alias], ref.col)
            return ColumnRef(rename(ref.alias), ref.col)

        outs.append(MemberOutput(
            name=query.name,
            src=remap_ref(query.src),
            dst=remap_ref(query.dst),
            branch_ids=tuple(member_branch_ids),
            residual_conds=tuple(residual),
        ))
    return MergedQuery(pattern=pattern, branches=tuple(branches),
                       members=tuple(outs))


# ---------------------------------------------------------------------------
# Cost (Eqs 3-4)
# ---------------------------------------------------------------------------

def estimate_merged(db: Database, merged: MergedQuery) -> Tuple[float, float]:
    """(cost, final rows) of the merged query per Eqs 3-4.

    Join(Q_M) = Join(SQ_S) + sum Join(SQ_i) + Outer(O)
    Outer(O)  = sum Build(SQ_i) + Probe(SQ_S)   [+ output bytes]

    The final cardinality multiplies S by each branch's expected match count
    (>= 1 because outer joins keep unmatched rows) — this is what penalizes
    merging N-to-N branches, the failure mode JS-MV exists for (§4.2).
    """
    s_est = estimate_query(db, shared_query(merged))
    cost = s_est.cost
    rows = s_est.rows
    width = s_est.width
    for b in merged.branches:
        if b.relations:
            b_est = estimate_query(db, b.as_query())
        else:
            continue
        cost += b_est.cost                      # Join(SQ_i)
        cost += C_BUILD * b_est.rows * b_est.width * 4.0   # Build(SQ_i)
        cost += 2 * C_FIXED                     # outer join + indicator ops
        # expected matches of this branch per current row
        sel = 1.0
        for c in b.link_conds:
            s_ndv = s_est.to_rel().col_ndv(c.left, c.lcol)
            b_ndv = b_est.to_rel().col_ndv(c.right, c.rcol)
            sel /= max(s_ndv, b_ndv)
        expansion = max(1.0, b_est.rows * sel)
        rows *= expansion
        width += b_est.width
    cost += C_PROBE * s_est.rows * s_est.width * 4.0        # Probe(SQ_S)
    cost += C_OUT * rows * width * 4.0                      # write result
    return cost, rows
