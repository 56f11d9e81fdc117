"""Graph-model IR: Definitions 2.1 (graph model) and 4.1 (join graph).

A :class:`JoinQuery` is the paper's join graph G = (V, E, f, g): aliases are
vertices, equality conditions are (multi-)edges, ``kind`` is f(e) and the
column pair is g(e).  Only equijoins are supported (all workloads in the
paper are equijoins); arbitrary predicates are expressed as per-relation
filters.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class Predicate:
    """sigma_{col op value} applied to one relation (pushed to the scan)."""

    col: str
    op: str
    value: float


@dataclasses.dataclass(frozen=True, order=True)
class Relation:
    """One vertex of the join graph: an aliased base table (or view)."""

    alias: str
    table: str
    filters: Tuple[Predicate, ...] = ()


@dataclasses.dataclass(frozen=True, order=True)
class JoinCond:
    """One edge of the join graph: ``left.lcol == right.rcol``."""

    left: str
    lcol: str
    right: str
    rcol: str

    def endpoints(self) -> FrozenSet[str]:
        return frozenset((self.left, self.right))

    def flipped(self) -> "JoinCond":
        return JoinCond(self.right, self.rcol, self.left, self.lcol)

    def touches(self, alias: str) -> bool:
        return self.left == alias or self.right == alias

    def oriented_from(self, alias: str) -> "JoinCond":
        """Return the condition with ``alias`` on the left."""
        if self.left == alias:
            return self
        if self.right == alias:
            return self.flipped()
        raise ValueError(f"{alias} not an endpoint of {self}")


@dataclasses.dataclass(frozen=True)
class ColumnRef:
    alias: str
    col: str

    def qualified(self) -> str:
        return f"{self.alias}.{self.col}"


@dataclasses.dataclass(frozen=True)
class JoinQuery:
    """Join graph of one edge definition (Def 4.1) plus output refs."""

    name: str
    relations: Tuple[Relation, ...]
    conds: Tuple[JoinCond, ...]
    src: ColumnRef
    dst: ColumnRef

    def __post_init__(self):
        aliases = [r.alias for r in self.relations]
        if len(set(aliases)) != len(aliases):
            raise ValueError(f"duplicate aliases in {self.name}: {aliases}")
        known = set(aliases)
        for c in self.conds:
            if c.left not in known or c.right not in known:
                raise ValueError(f"cond {c} references unknown alias")
        for ref in (self.src, self.dst):
            if ref.alias not in known:
                raise ValueError(f"output ref {ref} references unknown alias")

    # -- graph views ---------------------------------------------------------
    def relation(self, alias: str) -> Relation:
        for r in self.relations:
            if r.alias == alias:
                return r
        raise KeyError(alias)

    def aliases(self) -> Tuple[str, ...]:
        return tuple(r.alias for r in self.relations)

    def adjacency(self) -> Dict[str, List[JoinCond]]:
        adj: Dict[str, List[JoinCond]] = {r.alias: [] for r in self.relations}
        for c in self.conds:
            adj[c.left].append(c)
            adj[c.right].append(c)
        return adj

    def connected_components(
        self, aliases: Sequence[str]
    ) -> List[FrozenSet[str]]:
        """Components of the join graph restricted to ``aliases``."""
        alias_set = set(aliases)
        adj = {a: set() for a in alias_set}
        for c in self.conds:
            if c.left in alias_set and c.right in alias_set:
                adj[c.left].add(c.right)
                adj[c.right].add(c.left)
        seen, comps = set(), []
        for a in sorted(alias_set):
            if a in seen:
                continue
            stack, comp = [a], set()
            while stack:
                x = stack.pop()
                if x in comp:
                    continue
                comp.add(x)
                stack.extend(adj[x] - comp)
            seen |= comp
            comps.append(frozenset(comp))
        return comps

    def is_chain(self) -> bool:
        """True if the join graph is a simple path (GraphGen/R2GSync scope)."""
        if len(self.conds) != len(self.relations) - 1:
            return False
        deg = {r.alias: 0 for r in self.relations}
        for c in self.conds:
            deg[c.left] += 1
            deg[c.right] += 1
        ends = sum(1 for d in deg.values() if d == 1)
        mids = sum(1 for d in deg.values() if d == 2)
        return ends == 2 and ends + mids == len(self.relations)

    def chain_order(self) -> List[str]:
        """Aliases in path order (requires :meth:`is_chain`)."""
        adj = {r.alias: [] for r in self.relations}
        for c in self.conds:
            adj[c.left].append(c.right)
            adj[c.right].append(c.left)
        start = next(a for a, ns in adj.items() if len(ns) == 1)
        order, prev = [start], None
        while len(order) < len(self.relations):
            nxt = [n for n in adj[order[-1]] if n != prev]
            prev = order[-1]
            order.append(nxt[0])
        return order


@dataclasses.dataclass(frozen=True)
class VertexDef:
    """(l_v, R_v) of Def 2.1 plus the id column and properties extracted."""

    label: str
    table: str
    id_col: str
    props: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class EdgeDef:
    """(l_e, m_src, m_dst, Q) of Def 2.1."""

    label: str
    src_label: str
    dst_label: str
    query: JoinQuery


@dataclasses.dataclass(frozen=True)
class GraphModel:
    """M = (M_v, M_e) of Def 2.1."""

    name: str
    vertices: Tuple[VertexDef, ...]
    edges: Tuple[EdgeDef, ...]

    def edge(self, label: str) -> EdgeDef:
        for e in self.edges:
            if e.label == label:
                return e
        raise KeyError(label)

    def queries(self) -> List[JoinQuery]:
        return [e.query for e in self.edges]

    @staticmethod
    def builder(name: str):
        """Fluent construction: ``GraphModel.builder("m").vertex(...).edge(...).build()``."""
        from repro_torch.api.builder import GraphModelBuilder
        return GraphModelBuilder(name)


def model_tables(model: GraphModel) -> Tuple[str, ...]:
    """Every base table a model reads: vertex tables + edge-query relations.

    The engine keys its plan cache by the stats fingerprint of *these*
    tables only, so churn in unrelated tables cannot invalidate a model's
    cached plan; the refresh path uses the same set to scope changelog
    scans and churn accounting.
    """
    names = {v.table for v in model.vertices}
    for q in model.queries():
        names |= {r.table for r in q.relations}
    return tuple(sorted(names))


def join_schedule(
    query: JoinQuery, order: Sequence[str]
) -> List[Tuple[str, List[JoinCond], List[JoinCond]]]:
    """The per-step schedule of a left-deep join along ``order``.

    Returns one ``(alias, conds, closing)`` entry per join step: ``conds``
    are the conditions connecting ``alias`` to the already-joined set (in
    ``query.conds`` order — executors sort on the first and post-filter the
    rest), ``closing`` the cycle-closing conditions whose endpoints are both
    joined once ``alias`` is.  This is the single source of truth consumed
    by the eager executor, the cost model, and the compiled pipeline — a
    step's capacity estimate and its traced join must see the same
    conditions in the same roles.  Raises ``ValueError`` if ``order`` is
    disconnected or leaves conditions unapplied.
    """
    joined = {order[0]}
    remaining = list(query.conds)
    steps: List[Tuple[str, List[JoinCond], List[JoinCond]]] = []
    for alias in order[1:]:
        conds = [c for c in remaining
                 if (c.left == alias and c.right in joined)
                 or (c.right == alias and c.left in joined)]
        if not conds:
            raise ValueError(
                f"join order {tuple(order)} disconnected at {alias}")
        for c in conds:
            remaining.remove(c)
        joined.add(alias)
        closing = [c for c in remaining
                   if c.left in joined and c.right in joined]
        for c in closing:
            remaining.remove(c)
        steps.append((alias, conds, closing))
    if remaining:
        raise ValueError(f"unapplied conditions: {remaining}")
    return steps


# ---------------------------------------------------------------------------
# Pattern canonicalization (for shared-subgraph dedup and JS-MV view naming)
# ---------------------------------------------------------------------------

Signature = Tuple  # nested tuples, hashable


def pattern_signature(
    relations: Sequence[Relation], conds: Sequence[JoinCond]
) -> Signature:
    """Canonical, alias-independent signature of a connected join subgraph.

    Brute force over alias orderings grouped by table name (join graphs are
    tiny, per the paper's own exhaustive-search argument in Alg 1).
    """
    rels = sorted(relations)
    best: Optional[Signature] = None
    aliases = [r.alias for r in rels]
    for perm in itertools.permutations(range(len(rels))):
        # only consider permutations that keep table names sorted
        tables = [(rels[perm[i]].table, rels[perm[i]].filters) for i in range(len(rels))]
        if tables != sorted(tables):
            continue
        remap = {rels[perm[i]].alias: f"p{i}" for i in range(len(rels))}
        sig_conds = []
        for c in conds:
            a = (remap[c.left], c.lcol)
            b = (remap[c.right], c.rcol)
            sig_conds.append(tuple(sorted((a, b))))
        sig = (tuple(tables), tuple(sorted(sig_conds)))
        if best is None or sig < best:
            best = sig
    assert best is not None
    return best


def query_signature(query: JoinQuery) -> Signature:
    """Canonical, alias-independent signature of a whole edge query.

    Extends :func:`pattern_signature` with the (canonically remapped) src/dst
    output refs, so two queries get the same signature iff they compute the
    same edge table up to alias renaming.  Used as the plan-cache key by
    :class:`repro_torch.api.ExtractionEngine`.
    """
    rels = sorted(query.relations)
    best: Optional[Signature] = None
    for perm in itertools.permutations(range(len(rels))):
        tables = [(rels[perm[i]].table, rels[perm[i]].filters)
                  for i in range(len(rels))]
        if tables != sorted(tables):
            continue
        remap = {rels[perm[i]].alias: f"p{i}" for i in range(len(rels))}
        sig_conds = tuple(sorted(
            tuple(sorted(((remap[c.left], c.lcol), (remap[c.right], c.rcol))))
            for c in query.conds))
        sig = (
            tuple(tables),
            sig_conds,
            (remap[query.src.alias], query.src.col),
            (remap[query.dst.alias], query.dst.col),
        )
        if best is None or sig < best:
            best = sig
    assert best is not None
    return best


def model_signature(model: GraphModel) -> Signature:
    """Alias-independent signature of every edge query in a model.

    Two models share a signature iff their edge queries are pairwise
    isomorphic (same labels, tables, filters, join conditions and output
    columns) — exactly the condition under which an extraction plan computed
    for one is valid for the other.
    """
    return tuple(
        (e.label, e.src_label, e.dst_label, e.query.name,
         query_signature(e.query))
        for e in model.edges
    )
