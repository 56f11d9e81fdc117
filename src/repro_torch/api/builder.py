"""Fluent construction of graph models (Def 2.1) without nested dataclasses.

::

    model = (GraphModel.builder("recommendation")
             .vertex("Customer", table="customer", id_col="c_id",
                     props=("c_prop",))
             .vertex("Item", table="item", id_col="i_id")
             .edge("Buy", src="Customer", dst="Item",
                   relations=[("C", "customer"), ("F", "store_sales"),
                              ("I", "item")],
                   joins=["C.c_id == F.c_sk", "F.i_sk == I.i_id"])
             .build())

Join conditions are ``"alias.col == alias.col"`` strings; relation filters
accept ``"col >= 10"`` strings, ``(col, op, value)`` tuples or
:class:`Predicate` objects.  Edge endpoints default to the endpoint
vertex's id column when its table appears exactly once in the join graph
(``src_col="C1.c_id"`` disambiguates self-joins such as Co-purchase).

``model_from_spec`` / ``model_to_spec`` round-trip the same information
through plain dicts (and ``model_from_json`` through JSON text), for
models that live in config files rather than code.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.model import (
    ColumnRef,
    EdgeDef,
    GraphModel,
    JoinCond,
    JoinQuery,
    Predicate,
    Relation,
    VertexDef,
)

_FILTER_OPS = ("==", "!=", "<=", ">=", "<", ">")


def _parse_ref(text: str) -> ColumnRef:
    alias, _, col = text.partition(".")
    if not alias or not col:
        raise ValueError(f"column ref {text!r} is not 'alias.col'")
    return ColumnRef(alias.strip(), col.strip())


def _parse_join(spec: Union[str, JoinCond]) -> JoinCond:
    if isinstance(spec, JoinCond):
        return spec
    # only equijoins exist in the IR; reject !=, <=, >= etc. loudly rather
    # than letting the bare-'=' fallback swallow the extra operator char
    if any(op in spec for op in ("!=", "<=", ">=", "<", ">")):
        raise ValueError(
            f"join {spec!r}: only equijoins ('a.x == b.y') are supported; "
            "express other predicates as relation filters")
    for eq in ("==", "="):
        if eq in spec:
            left, _, right = spec.partition(eq)
            l, r = _parse_ref(left), _parse_ref(right)
            return JoinCond(l.alias, l.col, r.alias, r.col)
    raise ValueError(f"join {spec!r} is not 'alias.col == alias.col'")


def _parse_filter(spec) -> Predicate:
    if isinstance(spec, Predicate):
        return spec
    if isinstance(spec, str):
        for op in _FILTER_OPS:
            if op in spec:
                col, _, value = spec.partition(op)
                return Predicate(col.strip(), op, float(value))
        raise ValueError(f"filter {spec!r} has no operator in {_FILTER_OPS}")
    if isinstance(spec, Mapping):
        return Predicate(spec["col"], spec["op"], float(spec["value"]))
    col, op, value = spec
    return Predicate(col, op, float(value))


def _parse_relation(spec) -> Relation:
    if isinstance(spec, Relation):
        return spec
    if isinstance(spec, Mapping):
        filters = tuple(_parse_filter(f) for f in spec.get("filters", ()))
        return Relation(spec["alias"], spec["table"], filters)
    alias, table, *rest = spec
    filters = tuple(_parse_filter(f) for f in rest[0]) if rest else ()
    return Relation(alias, table, filters)


def join_query(name: str, relations: Sequence, joins: Sequence,
               src: str, dst: str) -> JoinQuery:
    """Build one edge query (Def 4.1 join graph) from compact specs."""
    return JoinQuery(
        name=name,
        relations=tuple(_parse_relation(r) for r in relations),
        conds=tuple(_parse_join(j) for j in joins),
        src=_parse_ref(src),
        dst=_parse_ref(dst),
    )


@dataclasses.dataclass
class _EdgeSpec:
    label: str
    src: str
    dst: str
    query: Optional[JoinQuery]
    relations: Optional[Sequence]
    joins: Optional[Sequence]
    src_col: Optional[str]
    dst_col: Optional[str]
    name: Optional[str]


class GraphModelBuilder:
    """Accumulates vertex/edge declarations; ``build()`` validates and
    assembles the (frozen) :class:`GraphModel`."""

    def __init__(self, name: str):
        self._name = name
        self._vertices: List[VertexDef] = []
        self._edges: List[_EdgeSpec] = []

    def vertex(self, label: str, *, table: str, id_col: str,
               props: Sequence[str] = ()) -> "GraphModelBuilder":
        if any(v.label == label for v in self._vertices):
            raise ValueError(f"duplicate vertex label {label!r}")
        self._vertices.append(
            VertexDef(label, table, id_col, tuple(props)))
        return self

    def edge(self, label: str, *, src: str, dst: str,
             query: Optional[JoinQuery] = None,
             relations: Optional[Sequence] = None,
             joins: Optional[Sequence] = None,
             src_col: Optional[str] = None,
             dst_col: Optional[str] = None,
             name: Optional[str] = None) -> "GraphModelBuilder":
        """Declare one edge: either a prebuilt ``query`` or relations+joins.

        ``src``/``dst`` are vertex labels; ``src_col``/``dst_col`` are
        ``"alias.col"`` output refs, inferred from the endpoint vertex's id
        column when that vertex's table occurs exactly once in the query.
        ``name`` overrides the edge-query (output) name, default ``label``.
        """
        if (query is None) == (relations is None):
            raise ValueError(
                f"edge {label!r}: pass exactly one of query= or relations=")
        if query is not None and (joins or src_col or dst_col):
            raise ValueError(
                f"edge {label!r}: joins/src_col/dst_col conflict with query=")
        self._edges.append(_EdgeSpec(label, src, dst, query, relations,
                                     joins or (), src_col, dst_col, name))
        return self

    def _vertex(self, label: str) -> VertexDef:
        for v in self._vertices:
            if v.label == label:
                return v
        raise ValueError(f"edge references undeclared vertex {label!r}")

    def _infer_ref(self, spec: _EdgeSpec, label: str,
                   relations: Sequence[Relation]) -> ColumnRef:
        vertex = self._vertex(label)
        hits = [r for r in relations if r.table == vertex.table]
        if len(hits) != 1:
            raise ValueError(
                f"edge {spec.label!r}: table {vertex.table!r} occurs "
                f"{len(hits)}x; pass src_col=/dst_col= explicitly")
        return ColumnRef(hits[0].alias, vertex.id_col)

    def _resolve(self, spec: _EdgeSpec) -> EdgeDef:
        for endpoint in (spec.src, spec.dst):
            self._vertex(endpoint)  # raises if undeclared
        if spec.query is not None:
            query = spec.query
            if spec.name is not None and spec.name != query.name:
                query = dataclasses.replace(query, name=spec.name)
            return EdgeDef(spec.label, spec.src, spec.dst, query)
        relations = tuple(_parse_relation(r) for r in spec.relations)
        src = (_parse_ref(spec.src_col) if spec.src_col
               else self._infer_ref(spec, spec.src, relations))
        dst = (_parse_ref(spec.dst_col) if spec.dst_col
               else self._infer_ref(spec, spec.dst, relations))
        query = JoinQuery(
            name=spec.name or spec.label,
            relations=relations,
            conds=tuple(_parse_join(j) for j in spec.joins),
            src=src,
            dst=dst,
        )
        return EdgeDef(spec.label, spec.src, spec.dst, query)

    def build(self) -> GraphModel:
        return GraphModel(
            name=self._name,
            vertices=tuple(self._vertices),
            edges=tuple(self._resolve(e) for e in self._edges),
        )


# ---------------------------------------------------------------------------
# Dict / JSON specs
# ---------------------------------------------------------------------------

def model_from_spec(spec: Mapping) -> GraphModel:
    """Assemble a model from a plain-dict spec (see ``model_to_spec``)."""
    b = GraphModelBuilder(spec["name"])
    for v in spec["vertices"]:
        b.vertex(v["label"], table=v["table"], id_col=v["id_col"],
                 props=tuple(v.get("props", ())))
    for e in spec["edges"]:
        b.edge(e["label"], src=e["src"], dst=e["dst"],
               relations=e["relations"], joins=e.get("joins", ()),
               src_col=e.get("src_col"), dst_col=e.get("dst_col"),
               name=e.get("name"))
    return b.build()


def model_from_json(text: str) -> GraphModel:
    return model_from_spec(json.loads(text))


def model_to_spec(model: GraphModel) -> Dict:
    """Inverse of ``model_from_spec``: a JSON-serializable dict."""
    edges = []
    for e in model.edges:
        q = e.query
        edge: Dict = {
            "label": e.label,
            "src": e.src_label,
            "dst": e.dst_label,
            "relations": [
                {"alias": r.alias, "table": r.table,
                 **({"filters": [dataclasses.asdict(f) for f in r.filters]}
                    if r.filters else {})}
                for r in q.relations
            ],
            "joins": [f"{c.left}.{c.lcol} == {c.right}.{c.rcol}"
                      for c in q.conds],
            "src_col": q.src.qualified(),
            "dst_col": q.dst.qualified(),
        }
        if q.name != e.label:
            edge["name"] = q.name
        edges.append(edge)
    return {
        "name": model.name,
        "vertices": [
            {"label": v.label, "table": v.table, "id_col": v.id_col,
             **({"props": list(v.props)} if v.props else {})}
            for v in model.vertices
        ],
        "edges": edges,
    }
