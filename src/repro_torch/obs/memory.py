"""Device-memory accounting: byte sizes from metadata, allocator watermarks.

Two complementary views of "what does the engine hold on the device":

* **Bottom-up** — :func:`entry_nbytes` sizes a cached object (Table,
  ExtractedGraph, CSRGraph, cached view/extraction wrappers) purely from
  tensor metadata (``numel() * element_size()``), so accounting never
  forces a device transfer.  The engine's ``_LRUCache``s use it to maintain
  per-cache resident-byte totals (``engine_cache_bytes`` gauges) and,
  optionally, byte-budget eviction.
* **Top-down** — :func:`device_memory_stats` samples PyTorch's CUDA caching
  allocator (``torch.cuda.memory_stats()``) into
  ``device_memory_bytes{device,kind}`` gauges; ``{}`` on the CPU.

Sizing is duck-typed on structural attributes rather than importing the
relational/graph layers: ``obs`` sits at the bottom of the dependency
stack and must not import upward.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.obs.metrics import REGISTRY

__all__ = ["array_nbytes", "table_nbytes", "graph_nbytes", "csr_nbytes",
           "entry_nbytes", "device_memory_stats"]


def array_nbytes(a) -> int:
    """Byte size of one tensor (or numpy array) from metadata."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    if isinstance(a, np.ndarray):
        return int(a.nbytes)
    return 0


def table_nbytes(t) -> int:
    """A relational ``Table``: every column plus the validity mask."""
    total = sum(array_nbytes(c) for c in t.columns.values())
    return total + array_nbytes(t.valid)


def csr_nbytes(csr) -> int:
    """A ``CSRGraph``: vertex ids plus per-label offset/target/source."""
    total = array_nbytes(getattr(csr, "vertex_ids", None))
    for field in ("offsets", "targets", "sources"):
        arrays = getattr(csr, field, None) or {}
        total += sum(array_nbytes(a) for a in arrays.values())
    return total


def graph_nbytes(g) -> int:
    """An ``ExtractedGraph``: vertex tables + edge tables."""
    total = 0
    for field in ("vertices", "edges"):
        tables = getattr(g, field, None) or {}
        for t in tables.values():
            total += table_nbytes(t)
    return total


def entry_nbytes(value) -> int:
    """Device-resident bytes of one engine cache entry (duck-typed).

    Host-only entries (plans) size to 0 — the gauges account for *device
    buffers*, not Python objects.  Cached views count only the
    materialized view table; their ``base_tables`` are shared references
    into the database snapshot, and counting them would double-bill every
    view against the same buffers.
    """
    if value is None:
        return 0
    if hasattr(value, "columns") and hasattr(value, "valid"):
        return table_nbytes(value)                      # Table
    if hasattr(value, "offsets") and hasattr(value, "vertex_ids"):
        return csr_nbytes(value)                        # CSRGraph
    if hasattr(value, "vertices") and hasattr(value, "edges"):
        return graph_nbytes(value)                      # ExtractedGraph
    if hasattr(value, "pattern") and hasattr(value, "table"):
        return entry_nbytes(value.table)                # _CachedView
    if hasattr(value, "graph") and hasattr(value, "plan"):
        return entry_nbytes(value.graph)                # _CachedExtraction
    return 0


def device_memory_stats(gauges: bool = True) -> Dict[str, Dict[str, int]]:
    """Live/peak/limit device bytes per CUDA device, mirrored into gauges.

    Returns ``{device: {"in_use": n, "peak": n, "limit": n}}``.  Without
    CUDA, or before anything touched the card (nothing allocated yet), the
    result is ``{}`` and nothing is gauged, so the call is safe to make
    unconditionally from ``cache_info()``.
    """
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        rec = {
            "in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak": int(stats.get("allocated_bytes.all.peak", 0)),
            "limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
        name = f"cuda:{i}"
        out[name] = rec
        if gauges:
            for kind, v in rec.items():
                REGISTRY.gauge(
                    "device_memory_bytes",
                    help="Device allocator watermarks (live/peak/limit).",
                    device=name, kind=kind).set(float(v))
    return out
