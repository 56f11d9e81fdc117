"""Pure-numpy ground truth for the graph algorithms (the contract
:mod:`repro_torch.graph.algorithms` is held against, as ``kernels/ref.py``
anchors the CUDA kernels).

All functions take host COO arrays ``(src, dst, valid)`` over dense vertex
indices — what ``CSRGraph.coo()`` returns, copied to the host
(``t.cpu().numpy()``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _compact(src, dst, valid):
    src = np.asarray(src)[np.asarray(valid)]
    dst = np.asarray(dst)[np.asarray(valid)]
    return src.astype(np.int64), dst.astype(np.int64)


def pagerank_np(src, dst, valid, num_vertices: int, iters: int = 20,
                damp: float = 0.85) -> np.ndarray:
    """Power iteration with uniform dangling-mass redistribution."""
    s, d = _compact(src, dst, valid)
    n = num_vertices
    deg = np.bincount(s, minlength=n).astype(np.float64)
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = np.divide(r, deg, out=np.zeros_like(r), where=deg > 0)
        agg = np.bincount(d, weights=contrib[s], minlength=n)
        dangling = r[deg == 0].sum()
        r = (1.0 - damp) / n + damp * (agg + dangling / n)
    return r.astype(np.float32)


def wcc_np(src, dst, valid, num_vertices: int) -> np.ndarray:
    """Undirected connected components; label = min vertex index."""
    s, d = _compact(src, dst, valid)
    labels = np.arange(num_vertices, dtype=np.int32)
    while True:
        new = labels.copy()
        np.minimum.at(new, d, labels[s])
        np.minimum.at(new, s, labels[d])
        if np.array_equal(new, labels):
            return labels
        labels = new


def khop_np(src, dst, valid, seed_mask, num_vertices: int,
            k: int = 2) -> np.ndarray:
    """Directed BFS distance from the seed set, -1 beyond ``k`` hops."""
    s, d = _compact(src, dst, valid)
    seed_mask = np.asarray(seed_mask, dtype=bool)
    dist = np.where(seed_mask, 0, -1).astype(np.int32)
    frontier = seed_mask.copy()
    visited = seed_mask.copy()
    for hop in range(1, k + 1):
        hit = np.zeros(num_vertices, dtype=bool)
        np.logical_or.at(hit, d, frontier[s])
        nxt = hit & ~visited
        dist[nxt] = hop
        visited |= nxt
        frontier = nxt
    return dist


def degree_stats_np(src, dst, valid, num_vertices: int) -> Dict[str, object]:
    s, d = _compact(src, dst, valid)
    out_deg = np.bincount(s, minlength=num_vertices).astype(np.int32)
    in_deg = np.bincount(d, minlength=num_vertices).astype(np.int32)
    return {
        "out_degree": out_deg,
        "in_degree": in_deg,
        "num_edges": int(len(s)),
        "max_out_degree": int(out_deg.max(initial=0)),
        "max_in_degree": int(in_deg.max(initial=0)),
        "mean_degree": len(s) / max(num_vertices, 1),
        "isolated": int(((out_deg + in_deg) == 0).sum()),
    }
