"""Step 3 of Definition 2.2: convert extracted vertices/edges into a graph.

The in-memory format is a per-edge-label CSR over *dense* vertex indices:
each vertex label owns a contiguous index range, edge endpoints are remapped
from user ids to dense indices with a sorted-id binary search, and row
offsets come from a histogram + exclusive scan (the classic GPU CSR build;
the ``segment_counts`` CUDA kernel computes the histogram on the card).

The build stays on the device: one tiny host sync fetches the per-table
valid-row counts, then the vertex ids are sorted, every edge endpoint is
remapped, and CSR + COO are laid out per edge label, all on the tensors'
device.  PyTorch runs eagerly, so there is no build executable to cache.

Alongside offsets/targets the builder keeps the source index per edge (COO
view, sorted by source), which is what the edge kernels in
:mod:`repro_torch.kernels` consume directly — see
:mod:`repro_torch.graph.algorithms` for PageRank / WCC / k-hop built on
top.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.extract import ExtractedGraph
from repro_torch.core.model import GraphModel
from repro_torch.relational import NULL_KEY, Table
from repro_torch.relational.table import host

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class CSRGraph:
    """Directed multigraph in CSR, vertices packed label-by-label.

    Per edge label, ``offsets[label]`` is the (V+1,) row-pointer array and
    ``targets[label]`` the column index sorted by source; ``sources[label]``
    carries the source index per edge (same order), so every edge label is
    simultaneously available as CSR and COO.  Invalid (padding or
    tombstoned) slots hold ``-1`` in both ``sources`` and ``targets``.
    Every array is int32 and lives on the device of the extracted tables.

    :meth:`apply_edge_delta` patches a label in place of a full rebuild:
    deleted edges are tombstoned (-1), inserted edges are appended as an
    unsorted COO tail.  Labels patched this way are listed in ``dirty`` —
    their ``offsets`` are stale (the COO view stays exact, which is all
    the edge-kernel algorithms consume) and ``out_degree`` falls back to a
    histogram until the garbage fraction crosses the compaction threshold
    and the label is re-sorted into clean CSR.
    """

    num_vertices: int
    vertex_ranges: Dict[str, Tuple[int, int]]      # label -> [start, end)
    vertex_ids: torch.Tensor                       # dense idx -> original id
    offsets: Dict[str, torch.Tensor]               # edge label -> (V+1,)
    targets: Dict[str, torch.Tensor]               # edge label -> (E,)
    sources: Dict[str, torch.Tensor]               # edge label -> (E,)
    edge_counts: Dict[str, int]
    dirty: FrozenSet[str] = frozenset()            # labels w/ stale offsets

    @property
    def device(self) -> torch.device:
        return self.vertex_ids.device

    def out_degree(self, label: str) -> torch.Tensor:
        if label in self.dirty:
            # offsets are stale on a patched label; histogram the COO view
            from repro_torch.kernels import ops as kops
            return kops.segment_counts(
                self.sources[label].clamp_min(0), self.edge_valid(label),
                self.num_vertices)
        off = self.offsets[label]
        return off[1:] - off[:-1]

    def in_degree(self, label: str,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
        """Histogram of targets (no transpose needed)."""
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ref as kref
        tgt = self.targets[label].clamp_min(0)
        valid = self.edge_valid(label)
        if kops.resolve_use_kernel(use_kernel, tgt.device):
            return kops.segment_counts(tgt, valid, self.num_vertices)
        return kref.segment_counts(tgt, valid, self.num_vertices)

    def edge_valid(self, label: str) -> torch.Tensor:
        return self.targets[label] >= 0

    def coo(self, labels: Optional[Sequence[str]] = None,
            symmetric: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(src, dst, valid) over the chosen edge labels, concatenated.

        ``symmetric=True`` appends every edge reversed — the undirected
        view WCC propagates over.
        """
        labels = self._labels(labels)
        src = torch.cat([self.sources[l] for l in labels])
        dst = torch.cat([self.targets[l] for l in labels])
        valid = (src >= 0) & (dst >= 0)
        if symmetric:
            src, dst = torch.cat([src, dst]), torch.cat([dst, src])
            valid = torch.cat([valid, valid])
        return src, dst, valid

    def _labels(self, labels: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
        if labels is None:
            return tuple(sorted(self.targets))
        if isinstance(labels, str):
            labels = (labels,)
        missing = [l for l in labels if l not in self.targets]
        if missing:
            raise KeyError(f"unknown edge labels {missing}; "
                           f"have {sorted(self.targets)}")
        return tuple(labels)

    def transpose(self, use_kernel: bool = False) -> "CSRGraph":
        """Reverse every edge label (src <-> dst); vertex numbering shared."""
        offsets: Dict[str, torch.Tensor] = {}
        targets: Dict[str, torch.Tensor] = {}
        sources: Dict[str, torch.Tensor] = {}
        for label in self.targets:
            src, dst = self.sources[label], self.targets[label]
            valid = self.edge_valid(label)
            off, tgt, srt = _coo_to_csr(dst, src, valid, self.num_vertices,
                                        use_kernel=use_kernel)
            offsets[label], targets[label], sources[label] = off, tgt, srt
        return CSRGraph(
            num_vertices=self.num_vertices,
            vertex_ranges=self.vertex_ranges,
            vertex_ids=self.vertex_ids,
            offsets=offsets,
            targets=targets,
            sources=sources,
            edge_counts=dict(self.edge_counts),
        )

    def apply_edge_delta(
        self,
        label: str,
        add_src=None,
        add_dst=None,
        del_src=None,
        del_dst=None,
        compact_threshold: float = 0.5,
        use_kernel: bool = False,
    ) -> "CSRGraph":
        """Patch one edge label with a signed delta; returns a new graph.

        ``add_*`` / ``del_*`` are dense vertex indices.  Deletions
        bag-cancel matching live edges into ``-1`` tombstones; insertions
        append an unsorted COO tail.  While the invalid fraction
        (tombstones + padding) stays at or below ``compact_threshold`` the
        label is only marked dirty — COO consumers (every registered
        algorithm) see the exact edge multiset, ``offsets`` go stale;
        above it the label is re-sorted into clean CSR on the device (the
        same ``_coo_to_csr`` pass a fresh build runs, minus the vertex
        remap).  Unpatched labels share their tensors with ``self``.
        """
        from repro_torch.relational import bag_cancel_mask

        dev = self.device
        src = host(self.sources[label])
        tgt = host(self.targets[label])
        valid = tgt >= 0
        n_live = int(self.edge_counts[label])

        if del_src is not None and len(np.asarray(del_src)):
            del_src = np.asarray(del_src, dtype=np.int32)
            del_dst = np.asarray(del_dst, dtype=np.int32)
            keep = bag_cancel_mask([src, tgt], valid, [del_src, del_dst])
            n_live -= int(valid.sum() - keep.sum())
            src = np.where(keep, src, -1).astype(np.int32)
            tgt = np.where(keep, tgt, -1).astype(np.int32)

        if add_src is not None and len(np.asarray(add_src)):
            add_src = np.asarray(add_src, dtype=np.int32)
            add_dst = np.asarray(add_dst, dtype=np.int32)
            src = np.concatenate([src, add_src])
            tgt = np.concatenate([tgt, add_dst])
            n_live += len(add_src)

        offsets = dict(self.offsets)
        targets = dict(self.targets)
        sources = dict(self.sources)
        counts = dict(self.edge_counts)
        counts[label] = n_live
        dirty = set(self.dirty)

        src_t = torch.from_numpy(src).to(dev)
        tgt_t = torch.from_numpy(tgt).to(dev)
        slots = len(tgt)
        garbage = 1.0 - (n_live / slots) if slots else 0.0
        if garbage > compact_threshold:
            off, t2, s2 = _coo_to_csr(src_t, tgt_t, tgt_t >= 0,
                                      self.num_vertices,
                                      use_kernel=use_kernel)
            cap = max(n_live, 1)
            offsets[label] = off
            targets[label] = t2[:cap].clone()
            sources[label] = s2[:cap].clone()
            dirty.discard(label)
        else:
            sources[label] = src_t
            targets[label] = tgt_t
            dirty.add(label)

        return CSRGraph(
            num_vertices=self.num_vertices,
            vertex_ranges=self.vertex_ranges,
            vertex_ids=self.vertex_ids,
            offsets=offsets,
            targets=targets,
            sources=sources,
            edge_counts=counts,
            dirty=frozenset(dirty),
        )


def csr_offsets(dst_rows: torch.Tensor, valid: torch.Tensor,
                num_vertices: int, use_kernel: bool = False) -> torch.Tensor:
    """Histogram source vertices + exclusive scan -> int32 row offsets."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    if use_kernel:
        counts = kops.segment_counts(dst_rows, valid, num_vertices)
    else:
        counts = kref.segment_counts(dst_rows, valid, num_vertices)
    zero = torch.zeros((1,), dtype=torch.int32, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, 0).to(torch.int32)])


def _coo_to_csr(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                num_vertices: int, use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort COO edges by source; -1-pad invalid slots (kept at the tail).

    The sort is stable, so targets within a row keep their input order,
    exactly as the reference's ``argsort(stable=True)``.
    """
    key = torch.where(valid, src, torch.full_like(src, _INT32_MAX))
    order = torch.argsort(key, stable=True)
    keep = valid[order]
    neg = torch.full_like(src, -1)
    tgt = torch.where(keep, dst[order], neg)
    srt = torch.where(keep, src[order], neg)
    if use_kernel:
        off = csr_offsets(src.clamp_min(0), valid, num_vertices,
                          use_kernel=True)
    else:
        # offsets straight off the sort: off[v] = #valid edges with src < v
        # (invalid slots sort to the tail as int32 max, past every vertex)
        off = torch.searchsorted(
            key[order],
            torch.arange(num_vertices + 1, dtype=torch.int32,
                         device=src.device),
            out_int32=True)
    return off, tgt, srt


def _count_rows(tables: Sequence[Table]) -> np.ndarray:
    """Valid-row counts of every table — the build's single host sync."""
    return host(torch.stack([t.num_rows() for t in tables]))


def _device_csr_build(
    vtabs: Tuple[Table, ...],
    etabs: Tuple[Table, ...],
    v_counts: Tuple[int, ...],
    edge_meta: Tuple[Tuple[int, int], ...],
    use_kernel: bool,
):
    """Id sort + dense remap + per-label CSR/COO layout, on the device.

    Invalid vertex slots sort to the tail as ``NULL_KEY``, so the rank of
    every live id in the full-capacity sorted array equals its rank among
    live ids only — the binary-search remap needs no host-side compaction.
    ``edge_meta[i]`` is the (src, dst) vertex-label index of edge table i.
    """
    num_vertices = sum(v_counts)
    sorted_ids = []
    bases = []
    base = 0
    for t, n in zip(vtabs, v_counts):
        ids = t["id"].to(torch.int32)
        key = torch.where(t.valid, ids, torch.full_like(ids, int(NULL_KEY)))
        sorted_ids.append(torch.sort(key).values)
        bases.append(base)
        base += n
    vertex_ids = torch.cat([s[:n] for s, n in zip(sorted_ids, v_counts)])
    outs = []
    for t, (si, di) in zip(etabs, edge_meta):
        src = torch.searchsorted(sorted_ids[si],
                                 t["src"].to(torch.int32).contiguous(),
                                 out_int32=True) + bases[si]
        dst = torch.searchsorted(sorted_ids[di],
                                 t["dst"].to(torch.int32).contiguous(),
                                 out_int32=True) + bases[di]
        outs.append(_coo_to_csr(src, dst, t.valid, num_vertices,
                                use_kernel=use_kernel))
    return vertex_ids, outs


def build_csr(
    graph: ExtractedGraph,
    model: GraphModel,
    use_kernel: bool = False,
) -> CSRGraph:
    from repro_torch import obs

    t_start = time.perf_counter()
    with obs.span("csr.build", category="csr", model=model.name):
        csr = _build_csr(graph, model, use_kernel)
    obs.REGISTRY.counter(
        "csr_builds_total", help="Full CSR conversions (cache misses).",
    ).inc()
    obs.REGISTRY.histogram(
        "csr_build_seconds", help="Wall time of a full CSR conversion.",
    ).observe(time.perf_counter() - t_start)
    return csr


def _build_csr(
    graph: ExtractedGraph,
    model: GraphModel,
    use_kernel: bool = False,
) -> CSRGraph:
    vlabels = tuple(sorted(graph.vertices))
    elabels = tuple(sorted(graph.edges))
    vtabs = tuple(graph.vertices[l] for l in vlabels)
    etabs = tuple(graph.edges[l] for l in elabels)

    # 1. the one host sync: valid-row counts of every table at once
    counts = _count_rows(vtabs + etabs)
    v_counts = tuple(int(c) for c in counts[:len(vlabels)])
    e_counts = [int(c) for c in counts[len(vlabels):]]

    # 2. dense vertex numbering, label by label (host metadata only)
    ranges: Dict[str, Tuple[int, int]] = {}
    base = 0
    for label, n in zip(vlabels, v_counts):
        ranges[label] = (base, base + n)
        base += n

    # 3. device build of ids + per-edge-label CSR (+ COO sources)
    by_label = {e.label: e for e in model.edges}
    edge_meta = tuple(
        (vlabels.index(by_label[l].src_label),
         vlabels.index(by_label[l].dst_label))
        for l in elabels)
    vertex_ids, outs = _device_csr_build(vtabs, etabs, v_counts, edge_meta,
                                         bool(use_kernel))

    offsets: Dict[str, torch.Tensor] = {}
    targets: Dict[str, torch.Tensor] = {}
    sources: Dict[str, torch.Tensor] = {}
    counts_d: Dict[str, int] = {}
    for label, (off, tgt, srt), n_edges in zip(elabels, outs, e_counts):
        cap = max(n_edges, 1)   # valid rows are prefix-compacted by the sort
        offsets[label] = off
        # copies, so the padding beyond cap is freed with the edge table
        targets[label] = tgt[:cap].clone()
        sources[label] = srt[:cap].clone()
        counts_d[label] = n_edges
    return CSRGraph(
        num_vertices=base,
        vertex_ranges=ranges,
        vertex_ids=vertex_ids,
        offsets=offsets,
        targets=targets,
        sources=sources,
        edge_counts=counts_d,
    )


def triangle_hint_degree(csr: CSRGraph, label: str) -> torch.Tensor:
    """Simple degree-based analytic used by the fraud example."""
    return csr.out_degree(label)
