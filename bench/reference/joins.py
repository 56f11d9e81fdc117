"""Plain reference of graph extraction: the model's joins, worked out again.

Reads a graph model in its JSON form (vertices; edges with ``relations``,
``joins`` as ``"A.x == B.y"`` strings, ``src_col``, ``dst_col``) and the
host arrays a generator made, and computes with plain PyTorch (CPU or
CUDA tensors):

* each edge label's bag of ``(src, dst)`` rows, packed as
  ``src << 32 | dst`` in one sorted int64 tensor: a join result row is one
  edge, duplicates kept;
* each vertex label's rows ``(id, props...)``, one int64 row a base-table
  row, sorted.

It evaluates every query on its own, in the order its joins are written,
as sort + binary search + expansion, and shares nothing between queries:
no view, no plan, no kernel of the program under test.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

Arrays = Mapping[str, Mapping[str, np.ndarray]]


def _ref(text: str) -> Tuple[str, str]:
    alias, _, col = text.strip().partition(".")
    if not alias or not col:
        raise ValueError(f"column ref {text!r} is not 'alias.col'")
    return alias, col


def _cond(text: str) -> Tuple[Tuple[str, str], Tuple[str, str]]:
    left, sep, right = text.partition("==")
    if not sep:
        raise ValueError(f"join {text!r} is not 'A.x == B.y'")
    return _ref(left), _ref(right)


def _needed(conds, src, dst) -> Dict[str, set]:
    need: Dict[str, set] = {}
    for a, b in conds:
        for alias, col in (a, b):
            need.setdefault(alias, set()).add(col)
    for alias, col in (src, dst):
        need.setdefault(alias, set()).add(col)
    return need


def _expand(bound: Dict[Tuple[str, str], torch.Tensor], probe: torch.Tensor,
            build: torch.Tensor, new_cols: Dict[Tuple[str, str], torch.Tensor]
            ) -> Dict[Tuple[str, str], torch.Tensor]:
    """Inner equijoin of the bound rows (key ``probe``) with a relation
    (key ``build``): every matching pair is one output row."""
    order = torch.argsort(build, stable=True)
    keys = build[order]
    lo = torch.searchsorted(keys, probe)
    hi = torch.searchsorted(keys, probe, right=True)
    counts = hi - lo
    total = int(counts.sum())
    dev = probe.device
    row = torch.repeat_interleave(
        torch.arange(probe.shape[0], device=dev), counts, output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(total, device=dev) - starts[row]
    ridx = order[lo[row] + rank]
    out = {k: v[row] for k, v in bound.items()}
    out.update({k: v[ridx] for k, v in new_cols.items()})
    return out


def edge_bag(arrays: Arrays, edge: Mapping, device) -> torch.Tensor:
    """Sorted packed ``src << 32 | dst`` int64 rows of one edge query."""
    if any(r.get("filters") for r in edge["relations"]):
        raise ValueError(f"edge {edge['label']!r}: filters are not modelled")
    tables = {r["alias"]: r["table"] for r in edge["relations"]}
    conds = [_cond(j) for j in edge["joins"]]
    src, dst = _ref(edge["src_col"]), _ref(edge["dst_col"])
    need = _needed(conds, src, dst)

    def load(alias):
        cols = arrays[tables[alias]]
        return {(alias, c): torch.as_tensor(cols[c], device=device)
                .to(torch.int64) for c in sorted(need[alias])}

    first = edge["relations"][0]["alias"]
    bound = load(first)
    aliases = {first}
    pending = list(range(len(conds)))
    while pending:
        progressed = False
        for i in list(pending):
            a, b = conds[i]
            if a[0] in aliases and b[0] in aliases:
                keep = bound[a] == bound[b]
                bound = {k: v[keep] for k, v in bound.items()}
            elif a[0] in aliases or b[0] in aliases:
                old, new = (a, b) if a[0] in aliases else (b, a)
                cols = load(new[0])
                bound = _expand(bound, bound[old], cols[new], cols)
                aliases.add(new[0])
            else:
                continue
            pending.remove(i)
            progressed = True
            # drop what no later join, nor the output, reads
            later = {ref for j in pending for ref in conds[j]} | {src, dst}
            bound = {k: v for k, v in bound.items() if k in later}
        if not progressed:
            raise ValueError(f"edge {edge['label']!r}: joins do not connect")
    return torch.sort((bound[src] << 32) | bound[dst]).values


def vertex_rows(arrays: Arrays, vertex: Mapping, device) -> torch.Tensor:
    """(rows, 1 + props) int64 rows ``(id, props...)``, sorted by rows."""
    cols = arrays[vertex["table"]]
    names = [vertex["id_col"], *vertex.get("props", ())]
    rows = torch.stack([torch.as_tensor(cols[n], device=device)
                        .to(torch.int64) for n in names], dim=1)
    return sort_rows(rows)


def sort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Rows of a 2-D tensor in lexicographic order (stable passes from
    the last column to the first)."""
    for j in reversed(range(rows.shape[1])):
        rows = rows[torch.argsort(rows[:, j], stable=True)]
    return rows


def extract(arrays: Arrays, model: Mapping, device
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """({edge label: packed sorted rows}, {vertex label: sorted rows})."""
    edges = {e["label"]: edge_bag(arrays, e, device) for e in model["edges"]}
    vertices = {v["label"]: vertex_rows(arrays, v, device)
                for v in model["vertices"]}
    return edges, vertices


def edge_labels(model: Mapping) -> List[str]:
    return [e["label"] for e in model["edges"]]
