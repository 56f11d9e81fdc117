"""Stage 3: walk the inferred FK graph into ranked GraphModel specs.

Vertex tables are the FK *parents* (tables referenced through a
high-uniqueness key).  Edges come from two generators over the FK graph:

* **path edges** — every simple path between two vertex tables, up to
  ``max_joins`` conditions.  Length-1 paths are direct FK edges
  (``paper -> venue``); length-2 paths are the classic fact-table pattern
  (``customer - store_sales - item``); longer chains recover multi-hop
  intents like DBLP's Auth-Edit (author - wrote - paper - venue - edits -
  editor).
* **co-role edges** — the JS-style many-to-many pattern through junction
  tables: ``E - F1 - S - F2 - E`` for entity E and shared vertex S, where
  F1/F2 each hold FKs to both.  With F1 == F2 this is the palindromic
  co-occurrence edge (Co-pur, Co-auth); with F1 != F2 it is the
  cross-junction pattern (IMDB's Wri-Dir: person - writes - movie -
  directs - person).

Every edge carries a confidence (product of its constituent FK
confidences — a chain is only as believable as its weakest link) and a
:class:`DiscoveryProvenance` recording which inferred FKs it was built
from.  Candidates are deduplicated by alias-independent
:func:`query_signature` and ranked; :meth:`DiscoveryResult.model_spec`
emits the top slice as a ``model_from_spec``-compatible dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.model import (
    ColumnRef,
    JoinCond,
    JoinQuery,
    Relation,
    Signature,
    query_signature,
)
from repro_torch.discovery.infer import JoinKeyCandidate
from repro_torch.discovery.profile import TableProfile


@dataclasses.dataclass(frozen=True)
class DiscoveryProvenance:
    """How one edge candidate was derived from the inferred FK graph."""

    kind: str        # "path" | "co_role"
    # one (child_table, child_col, parent_table, parent_col, confidence)
    # tuple per join condition, in join order
    fks: Tuple[Tuple[str, str, str, str, float], ...]

    def as_dict(self) -> Dict[str, object]:
        return {"kind": self.kind,
                "fks": [{"child": f"{ct}.{cc}", "parent": f"{pt}.{pc}",
                         "confidence": round(conf, 4)}
                        for ct, cc, pt, pc, conf in self.fks]}


@dataclasses.dataclass(frozen=True)
class VertexCandidate:
    label: str
    table: str
    id_col: str
    confidence: float                          # best referencing FK
    referenced_by: Tuple[Tuple[str, str], ...]  # (child_table, child_col)


@dataclasses.dataclass
class EdgeCandidate:
    label: str
    src: str                     # vertex label
    dst: str
    relations: List[List[str]]   # [alias, table] pairs (spec form)
    joins: List[str]
    src_col: str
    dst_col: str
    confidence: float
    provenance: DiscoveryProvenance
    query: JoinQuery = dataclasses.field(repr=False, default=None)
    signature: Signature = dataclasses.field(repr=False, default=None)

    def spec(self) -> Dict[str, object]:
        """One ``model_from_spec`` edge entry (extra keys are ignored by
        the builder but kept for human review)."""
        return {"label": self.label, "src": self.src, "dst": self.dst,
                "relations": [list(r) for r in self.relations],
                "joins": list(self.joins),
                "src_col": self.src_col, "dst_col": self.dst_col,
                "confidence": round(self.confidence, 4),
                "provenance": self.provenance.as_dict()}


# -- internals ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Link:
    """One accepted FK as an undirected join-graph edge."""

    child_table: str
    child_col: str
    parent_table: str
    parent_col: str
    confidence: float

    def other(self, table: str) -> str:
        return self.parent_table if table == self.child_table \
            else self.child_table

    def cols(self, left_table: str) -> Tuple[str, str]:
        """(left_col, right_col) when traversed from ``left_table``."""
        if left_table == self.child_table:
            return self.child_col, self.parent_col
        return self.parent_col, self.child_col

    def fk_tuple(self) -> Tuple[str, str, str, str, float]:
        return (self.child_table, self.child_col, self.parent_table,
                self.parent_col, self.confidence)


def _label(table: str) -> str:
    return "".join(p.capitalize() for p in table.split("_") if p) or table


def _alias(table: str, i: int) -> str:
    initials = "".join(p[0] for p in table.split("_") if p).upper()
    return f"{initials or 'T'}{i}"


def _build_query(name: str, tables: Sequence[str],
                 links: Sequence[_Link], src_id: str, dst_id: str
                 ) -> Tuple[JoinQuery, List[List[str]], List[str], str, str]:
    """A chain query over ``tables`` joined by ``links`` (len = n-1)."""
    aliases = [_alias(t, i) for i, t in enumerate(tables)]
    relations = tuple(Relation(a, t) for a, t in zip(aliases, tables))
    conds = []
    joins = []
    for i, link in enumerate(links):
        lcol, rcol = link.cols(tables[i])
        conds.append(JoinCond(aliases[i], lcol, aliases[i + 1], rcol))
        joins.append(f"{aliases[i]}.{lcol} == {aliases[i + 1]}.{rcol}")
    src_col = f"{aliases[0]}.{src_id}"
    dst_col = f"{aliases[-1]}.{dst_id}"
    query = JoinQuery(name=name, relations=relations, conds=tuple(conds),
                      src=ColumnRef(aliases[0], src_id),
                      dst=ColumnRef(aliases[-1], dst_id))
    spec_rels = [[a, t] for a, t in zip(aliases, tables)]
    return query, spec_rels, joins, src_col, dst_col


def synthesize(fks: Sequence[JoinKeyCandidate],
               profiles: Optional[Dict[str, TableProfile]] = None, *,
               max_joins: int = 5,
               min_edge_confidence: float = 0.05,
               max_paths_per_root: int = 256
               ) -> Tuple[List[VertexCandidate], List[EdgeCandidate]]:
    """Vertex tables + ranked edge candidates from accepted FKs."""
    links = [_Link(c.child_table, c.child_col, c.parent_table,
                   c.parent_col, c.confidence) for c in fks]

    # vertex tables: FK parents; id_col = the most-referenced parent column
    refs: Dict[str, Dict[str, List[_Link]]] = {}
    for l in links:
        refs.setdefault(l.parent_table, {}).setdefault(
            l.parent_col, []).append(l)
    vertices: Dict[str, VertexCandidate] = {}
    labels_used: Dict[str, str] = {}
    for table in sorted(refs):
        by_col = refs[table]
        id_col = max(sorted(by_col),
                     key=lambda c: (len(by_col[c]),
                                    max(l.confidence for l in by_col[c])))
        label = _label(table)
        if label in labels_used and labels_used[label] != table:
            label = f"{label}_{len(labels_used)}"
        labels_used[label] = table
        all_refs = [l for ls in by_col.values() for l in ls]
        vertices[table] = VertexCandidate(
            label=label, table=table, id_col=id_col,
            confidence=max(l.confidence for l in all_refs),
            referenced_by=tuple(sorted((l.child_table, l.child_col)
                                       for l in all_refs)))

    adj: Dict[str, List[_Link]] = {}
    for l in links:
        adj.setdefault(l.child_table, []).append(l)
        adj.setdefault(l.parent_table, []).append(l)

    edges: List[EdgeCandidate] = []

    def add_edge(kind: str, tables: Sequence[str], chain: Sequence[_Link]):
        conf = 1.0
        for l in chain:
            conf *= l.confidence
        if conf < min_edge_confidence:
            return
        sv, dv = vertices[tables[0]], vertices[tables[-1]]
        label = f"{sv.label}To{dv.label}"
        query, rels, joins, src_col, dst_col = _build_query(
            label, tables, chain, sv.id_col, dv.id_col)
        edges.append(EdgeCandidate(
            label=label, src=sv.label, dst=dv.label, relations=rels,
            joins=joins, src_col=src_col, dst_col=dst_col,
            confidence=conf,
            provenance=DiscoveryProvenance(
                kind=kind, fks=tuple(l.fk_tuple() for l in chain)),
            query=query, signature=query_signature(query)))

    # -- path edges: simple paths between vertex tables ----------------------
    for root in sorted(vertices):
        emitted = 0

        def walk(table: str, visited: Tuple[str, ...],
                 chain: Tuple[_Link, ...]):
            nonlocal emitted
            if emitted >= max_paths_per_root:
                return
            if chain and table in vertices:
                add_edge("path", visited, chain)
                emitted += 1
            if len(chain) >= max_joins:
                return
            for link in adj.get(table, ()):
                nxt = link.other(table)
                if nxt in visited:
                    continue
                walk(nxt, visited + (nxt,), chain + (link,))

        walk(root, (root,), ())

    # -- co-role edges: E - F1 - S - F2 - E through junction tables ----------
    # parent_links[t] = accepted FKs *from* t, grouped by parent table
    parent_links: Dict[str, Dict[str, List[_Link]]] = {}
    for l in links:
        parent_links.setdefault(l.child_table, {}).setdefault(
            l.parent_table, []).append(l)
    juncts = sorted(t for t, ps in parent_links.items() if len(ps) >= 2)
    for f1 in juncts:
        for f2 in juncts:
            for e in sorted(set(parent_links[f1]) & set(parent_links[f2])):
                for s in sorted(set(parent_links[f1])
                                & set(parent_links[f2])):
                    if e == s or e not in vertices or s not in vertices:
                        continue
                    for le1 in parent_links[f1][e]:
                        for ls1 in parent_links[f1][s]:
                            for ls2 in parent_links[f2][s]:
                                for le2 in parent_links[f2][e]:
                                    add_edge("co_role", (e, f1, s, f2, e),
                                             (le1, ls1, ls2, le2))

    # dedupe by canonical signature (path and co-role generators can meet),
    # keep the most confident witness, rank by confidence
    best: Dict[Signature, EdgeCandidate] = {}
    for e in edges:
        cur = best.get(e.signature)
        if cur is None or e.confidence > cur.confidence:
            best[e.signature] = e
    ranked = sorted(best.values(),
                    key=lambda e: (-e.confidence, e.label, e.src_col))
    seen: Dict[str, int] = {}
    for e in ranked:
        n = seen.get(e.label, 0)
        seen[e.label] = n + 1
        if n:
            e.label = f"{e.label}_{n + 1}"
    return sorted(vertices.values(), key=lambda v: v.label), ranked


@dataclasses.dataclass
class DiscoveryResult:
    """Everything one discovery pass learned, ranked and replayable."""

    profiles: Dict[str, TableProfile]
    candidates: List[JoinKeyCandidate]     # every validated hypothesis
    fks: List[JoinKeyCandidate]            # accepted, sorted by confidence
    vertices: List[VertexCandidate]
    edges: List[EdgeCandidate]             # ranked by confidence
    timings: Dict[str, float]
    stats: Dict[str, object]
    params: Dict[str, object]

    def model_spec(self, top: Optional[int] = None,
                   name: str = "discovered") -> Dict[str, object]:
        """A ``model_from_spec``-compatible dict of the top-ranked edges."""
        chosen = self.edges if top is None else self.edges[:top]
        used = {e.src for e in chosen} | {e.dst for e in chosen}
        verts = [v for v in self.vertices if v.label in used]
        return {
            "name": name,
            "vertices": [{"label": v.label, "table": v.table,
                          "id_col": v.id_col,
                          "confidence": round(v.confidence, 4)}
                         for v in verts],
            "edges": [e.spec() for e in chosen],
        }

    def describe(self, top: int = 10) -> str:
        lines = [f"{len(self.profiles)} tables profiled, "
                 f"{len(self.candidates)} FK candidates, "
                 f"{len(self.fks)} accepted "
                 f"({self.stats.get('containment_checks', 0)} containment "
                 f"checks, compiled={self.stats.get('all_compiled', False)})"]
        for fk in self.fks:
            lines.append(f"  fk  {fk.describe()}")
        lines.append(f"{len(self.vertices)} vertex tables, "
                     f"{len(self.edges)} edge candidates; top {top}:")
        for e in self.edges[:top]:
            route = " - ".join([e.relations[0][1]]
                               + [r[1] for r in e.relations[1:]])
            lines.append(f"  edge {e.label}: {route} "
                         f"(conf={e.confidence:.2f}, "
                         f"{e.provenance.kind})")
        return "\n".join(lines)
