"""What decides ``correct``: the program's graphs against the reference.

Every number compared is a count of rows by which two bags differ,
``sum over rows x of |count_a(x) - count_b(x)|``, so the limit of each is
0: the comparison is exact.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

from reference import joins

LIMITS = {"edge_rows_off": 0, "edge_count_off": 0, "vertex_rows_off": 0,
          "requests_failed": 0}


def bag_off(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows by which bags ``a`` and ``b`` differ (1-D values or 2-D rows)."""
    if a.shape == b.shape:
        if a.dim() == 1 and torch.equal(torch.sort(a).values,
                                         torch.sort(b).values):
            return 0
        if a.dim() == 2 and torch.equal(joins.sort_rows(a),
                                         joins.sort_rows(b)):
            return 0
    keys = torch.cat([a, b.to(a.device)])
    weight = torch.cat([torch.ones(a.shape[0], dtype=torch.int64,
                                   device=a.device),
                        -torch.ones(b.shape[0], dtype=torch.int64,
                                    device=a.device)])
    dim = None if keys.dim() == 1 else 0
    _, inverse = torch.unique(keys, dim=dim, return_inverse=True)
    net = torch.zeros(int(inverse.max()) + 1 if inverse.numel() else 0,
                      dtype=torch.int64, device=a.device)
    net.scatter_add_(0, inverse, weight)
    return int(net.abs().sum())


def program_edges(graph, labels: Sequence[str], device=None
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The valid ``(src, dst)`` int32 columns of each edge table, on
    ``device`` (default: where they are)."""
    out = {}
    for label in labels:
        t = graph.edges[label]
        dev = device or t.device
        out[label] = (t["src"][t.valid].to(dev), t["dst"][t.valid].to(dev))
    return out


def packed(edges: Mapping[str, Tuple[torch.Tensor, torch.Tensor]], device
           ) -> Dict[str, torch.Tensor]:
    """Each label's rows as int64 ``src << 32 | dst`` on ``device``."""
    return {k: (s.to(device).to(torch.int64) << 32)
            | d.to(device).to(torch.int64) for k, (s, d) in edges.items()}


def program_vertices(graph, model: Mapping, device=None
                     ) -> Dict[str, torch.Tensor]:
    """The valid ``(id, props...)`` rows of each vertex table (int64)."""
    out = {}
    for v in model["vertices"]:
        t = graph.vertices[v["label"]]
        names = ["id", *v.get("props", ())]
        dev = device or t.device
        out[v["label"]] = torch.stack(
            [t[n][t.valid].to(dev).to(torch.int64) for n in names], dim=1)
    return out


def compare(got: Tuple[Dict, Dict], want: Tuple[Dict, Dict]
            ) -> Tuple[int, int]:
    """(edge rows off, vertex rows off) of one extraction."""
    (ge, gv), (we, wv) = got, want
    edge_off = sum(bag_off(ge[k], we[k]) if k in ge else int(we[k].shape[0])
                   for k in we)
    vertex_off = sum(bag_off(gv[k], wv[k]) if k in gv
                     else int(wv[k].shape[0]) for k in wv)
    return edge_off, vertex_off


def verdict(values: Mapping[str, int]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {name: {"value", "limit"}}) in :data:`LIMITS` order."""
    checks = {k: {"value": int(values[k]), "limit": LIMITS[k]}
              for k in LIMITS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
