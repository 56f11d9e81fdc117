"""Graph algorithms over :class:`CSRGraph`, as loops over the edge kernels
(``edge_spmv`` / ``edge_min_label`` / ``frontier_expand`` /
``segment_counts`` in :mod:`repro_torch.kernels`).

Every algorithm takes the COO view of one edge label (or the union of all
labels), runs its iteration as a Python loop over tensors (the reference's
``lax.scan`` / ``while_loop`` / ``fori_loop``), and is registered in
:data:`ALGORITHMS` so :meth:`repro_torch.api.ExtractionEngine.analyze` can
dispatch by name.  ``use_kernel`` selects the compute path: ``None``
(default) follows the tensors' device — the CUDA kernels on the card, their
plain PyTorch versions from :mod:`repro_torch.kernels.ref` on the CPU;
``True``/``False`` force it.  Both paths have the same semantics (the
float32 sums of ``edge_spmv`` aside, whose order differs); the numpy
ground truth lives in :mod:`repro_torch.graph.reference`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def _launched(algorithm: str, use_kernel: bool) -> None:
    """Count one algorithm run (host-side: the per-edge kernel launches
    inside the loop are counted by the kernel wrappers)."""
    from repro_torch import obs

    obs.REGISTRY.counter(
        "graph_algorithm_runs_total",
        help="Graph-algorithm loop runs.",
        algorithm=algorithm,
        kernel="cuda" if use_kernel else "torch").inc()


def _spmv(src, dst, valid, x, n, use_kernel):
    if use_kernel:
        return kops.edge_spmv(src, dst, valid, x, n)
    return kref.edge_spmv(src, dst, valid, x, n)


def _min_label(src, dst, valid, labels, n, use_kernel):
    if use_kernel:
        return kops.edge_min_label(src, dst, valid, labels, n)
    return kref.edge_min_label(src, dst, valid, labels, n)


def _expand(src, dst, valid, frontier, visited, n, use_kernel):
    if use_kernel:
        return kops.frontier_expand(src, dst, valid, frontier, visited, n)
    return kref.frontier_expand(src, dst, valid, frontier, visited, n)


def _out_degree(src, valid, n, use_kernel):
    if use_kernel:
        return kops.segment_counts(src, valid, n)
    return kref.segment_counts(src.clamp_min(0), valid, n)


# -- PageRank ---------------------------------------------------------------

def _pagerank_loop(src, dst, valid, num_vertices: int, iters: int,
                   damp: float, use_kernel: bool) -> torch.Tensor:
    """float32 throughout, as the reference: ``damp`` is a float32 scalar
    and every update is a float32 tensor op.  No host sync."""
    n = num_vertices
    dev = src.device
    deg = _out_degree(src, valid, n, use_kernel).to(torch.float32)
    has_out = deg > 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    d = torch.tensor(damp, dtype=torch.float32, device=dev)
    teleport = (1.0 - d) / n
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        contrib = torch.where(has_out, r / deg.clamp_min(1.0), zero)
        agg = _spmv(src, dst, valid, contrib, n, use_kernel)
        dangling = torch.where(has_out, zero, r).sum()
        r = teleport + d * (agg + dangling / n)
    return r


def pagerank(csr: CSRGraph, label: Optional[str] = None, iters: int = 20,
             damp: float = 0.85,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Power-iteration PageRank (dangling mass redistributed uniformly)."""
    src, dst, valid = csr.coo(label)
    uk = kops.resolve_use_kernel(use_kernel, src.device)
    _launched("pagerank", uk)
    return _pagerank_loop(src, dst, valid, csr.num_vertices, int(iters),
                          float(damp), uk)


# -- Weakly connected components --------------------------------------------

def _wcc_loop(src, dst, valid, num_vertices: int, max_iters: int,
              use_kernel: bool):
    """Min-label propagation to a fixed point.

    The ``changed`` test costs one host sync per iteration
    (``bool((new != labels).any())``); capturing the loop in a CUDA graph,
    or a device-side flag checked every few steps, is later work.
    """
    labels = torch.arange(num_vertices, dtype=torch.int32, device=src.device)
    iters = 0
    changed = True
    while changed and iters < max_iters:
        new = _min_label(src, dst, valid, labels, num_vertices, use_kernel)
        changed = bool((new != labels).any())
        labels = new
        iters += 1
    return labels, iters


def wcc(csr: CSRGraph, label: Optional[str] = None,
        max_iters: Optional[int] = None,
        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Weakly connected components: min-label propagation to fixed point.

    Returns per-vertex component labels — the smallest dense vertex index
    in each component.  Edge direction is ignored (both directions
    propagate).  One host sync per iteration (see :func:`_wcc_loop`).
    """
    src, dst, valid = csr.coo(label, symmetric=True)
    if max_iters is None:
        max_iters = max(csr.num_vertices, 1)
    uk = kops.resolve_use_kernel(use_kernel, src.device)
    _launched("wcc", uk)
    labels, _ = _wcc_loop(src, dst, valid, csr.num_vertices, int(max_iters),
                          uk)
    return labels


# -- k-hop neighborhoods -----------------------------------------------------

def _khop_loop(src, dst, valid, seed_mask, num_vertices: int, k: int,
               use_kernel: bool) -> torch.Tensor:
    n = num_vertices
    dist = torch.where(seed_mask, 0, -1).to(torch.int32)
    frontier, visited = seed_mask, seed_mask
    for i in range(k):
        nxt = _expand(src, dst, valid, frontier, visited, n, use_kernel)
        dist = torch.where(nxt, torch.full_like(dist, i + 1), dist)
        frontier, visited = nxt, visited | nxt
    return dist


def khop(csr: CSRGraph, seeds: Union[torch.Tensor, np.ndarray, Sequence[int]],
         k: int = 2, label: Optional[str] = None,
         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """BFS hop distance from ``seeds``, truncated at ``k``.

    ``seeds`` is a bool mask over dense vertex indices or an index array.
    Returns int32 distances; ``-1`` marks vertices unreached within k hops.
    """
    src, dst, valid = csr.coo(label)
    n = csr.num_vertices
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.from_numpy(np.asarray(seeds))
    seeds = seeds.to(src.device)
    if seeds.dtype == torch.bool:
        seed_mask = seeds.contiguous()
    else:
        # as the reference's .at[int32 seeds].set: an index in [-n, 0)
        # wraps, one outside [-n, n) is dropped (into a spare last slot)
        idx = seeds.to(torch.int32).to(torch.int64)
        idx = torch.where(idx < 0, idx + n, idx)
        idx = torch.where((idx >= 0) & (idx < n), idx, n)
        seed_mask = torch.zeros((n + 1,), dtype=torch.bool, device=src.device)
        seed_mask[idx] = True
        seed_mask = seed_mask[:n]
    uk = kops.resolve_use_kernel(use_kernel, src.device)
    _launched("khop", uk)
    return _khop_loop(src, dst, valid, seed_mask, n, int(k), uk)


# -- degree statistics -------------------------------------------------------

def _degree_stats(src, dst, valid, num_vertices: int, use_kernel: bool):
    n = num_vertices
    out_deg = _out_degree(src, valid, n, use_kernel)
    in_deg = _out_degree(dst.clamp_min(0), valid & (dst >= 0), n, use_kernel)
    num_edges = valid.sum(dtype=torch.int32)
    return {
        "out_degree": out_deg,
        "in_degree": in_deg,
        "num_edges": num_edges,
        "max_out_degree": out_deg.max(),
        "max_in_degree": in_deg.max(),
        "mean_degree": num_edges / max(n, 1),
        "isolated": ((out_deg + in_deg) == 0).sum(dtype=torch.int32),
    }


def degree_stats(csr: CSRGraph, label: Optional[str] = None,
                 use_kernel: Optional[bool] = None
                 ) -> Dict[str, torch.Tensor]:
    """Out/in degree arrays + summary scalars over the chosen edges."""
    src, dst, valid = csr.coo(label)
    uk = kops.resolve_use_kernel(use_kernel, src.device)
    _launched("degree_stats", uk)
    return _degree_stats(src, dst, valid, csr.num_vertices, uk)


# -- registry (engine.analyze dispatches through this) -----------------------

ALGORITHMS: Dict[str, Callable] = {
    "pagerank": pagerank,
    "wcc": wcc,
    "khop": khop,
    "degree_stats": degree_stats,
}
