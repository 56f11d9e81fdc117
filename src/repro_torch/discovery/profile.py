"""Stage 1: per-column profiles, batched on the table's device.

The catalog's :class:`TableStats` already carries row counts, exact-ish
NDV and min/max for int columns; what discovery additionally needs is a
*uniformly trustworthy* key-ness signal — after incremental churn the
catalog NDVs are approximations with unknown error, and float/null
structure is not covered at all.  So profiling runs one batched pass per
table: every int column is hashed, sorted, deduplicated and reduced to a
k-minimum-values (KMV) sketch, with live/null counts folded into the same
pass.  The host then turns each sketch into an NDV estimate
(``(k-1) * 2^32 / kth_min`` once k distinct hashes exist, exact below
that), which drives uniqueness = ndv / non_null — the signal stages 2-3
use to tell keys from foreign keys from payload columns.

The uint32 hash runs in int64 with the low 32 bits kept after every
multiply (an int64 product wraps mod 2**64, so the mask is exact); the
sketch is bit-equal to the JAX package's, ``0xFFFFFFFF`` padding included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.database import Database, Fingerprint, TableStats
from repro_torch.relational import Table
from repro_torch.relational.table import NULL_KEY, host

SKETCH_K = 256
_U32_MAX = np.uint32(0xFFFFFFFF)
_U32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer hash of int32 values, as uint32 in int64."""
    x = x.to(torch.int64) & _U32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return x


def _sketch_columns(cols: torch.Tensor, valid: torch.Tensor, k: int):
    """KMV sketch + live/null counts for a (C, cap) stack of int32 columns.

    Returns ``(kmins (C, k) uint32 numpy, n_live (C,), n_null (C,))`` where
    a ``kmins`` slot of ``0xFFFFFFFF`` means "fewer than k distinct
    hashes".
    """
    null = valid & (cols == int(NULL_KEY))
    live = valid & (cols != int(NULL_KEY))
    h = torch.where(live, _mix32(cols), _U32)
    hs = torch.sort(h, dim=1).values
    # the k smallest distinct hashes are the first k run heads of the
    # sorted row, in order; the rest of the sketch stays 0xFFFFFFFF
    head = torch.ones_like(hs, dtype=torch.bool)
    head[:, 1:] = hs[:, 1:] != hs[:, :-1]
    rank = torch.cumsum(head, dim=1) - 1
    take = head & (rank < k)
    row = torch.arange(hs.shape[0], device=hs.device)[:, None].expand_as(hs)
    kmins = torch.full((hs.shape[0], k), _U32, dtype=torch.int64,
                       device=hs.device)
    kmins[row[take], rank[take]] = hs[take]
    return (host(kmins).astype(np.uint32), host(live.sum(dim=1)),
            host(null.sum(dim=1)))


def _estimate_ndv(kmins: np.ndarray, k: int) -> int:
    """NDV from one KMV sketch: exact under k distinct, estimated above."""
    vals = kmins[kmins < _U32_MAX]
    m = int(vals.size)
    if m < k:
        return m
    kth = float(vals[k - 1]) + 1.0
    return int(round((k - 1) * (2.0 ** 32) / kth))


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


@dataclasses.dataclass(frozen=True)
class ColumnProfile:
    """What discovery knows about one column."""

    table: str
    column: str
    dtype: str                     # "int" | "float"
    rows: int                      # live rows in the table
    non_null: int                  # live rows whose value is not NULL_KEY
    null_frac: float
    ndv: int                       # KMV estimate (exact below sketch k)
    ndv_stats: Optional[int]       # catalog NDV, possibly approximate
    minmax: Optional[Tuple[int, int]]
    uniqueness: float              # ndv / non_null, in [0, 1]
    density: float                 # ndv / range width, 0 when unknown

    @property
    def joinable(self) -> bool:
        return self.dtype == "int" and self.non_null > 0

    def key_like(self, threshold: float = 0.9,
                 max_null: float = 0.01) -> bool:
        """Could this column be a primary/unique key?"""
        return (self.joinable and self.uniqueness >= threshold
                and self.null_frac <= max_null)


@dataclasses.dataclass(frozen=True)
class TableProfile:
    name: str
    rows: int
    capacity: int
    columns: Dict[str, ColumnProfile]
    stats_fingerprint: Fingerprint
    profile_s: float = 0.0

    def key_columns(self, threshold: float = 0.9,
                    max_null: float = 0.01) -> Tuple[str, ...]:
        return tuple(c for c, p in sorted(self.columns.items())
                     if p.key_like(threshold, max_null))


def profile_table(name: str, table: Table, stats: TableStats,
                  k: int = SKETCH_K) -> TableProfile:
    """Profile every column of one table (one batched sketch pass)."""
    t0 = time.perf_counter()
    rows = int(table.valid.sum())
    int_cols = [c for c in table.column_names() if _is_int(table[c])]
    profiles: Dict[str, ColumnProfile] = {}

    if int_cols and table.capacity:
        stack = torch.stack([table[c].to(torch.int32) for c in int_cols])
        kmins, n_live, n_null = _sketch_columns(stack, table.valid, k)
        for i, c in enumerate(int_cols):
            live = int(n_live[i])
            ndv = _estimate_ndv(kmins[i], k)
            mm = stats.minmax.get(c)
            width = (mm[1] - mm[0] + 1) if mm is not None else 0
            profiles[c] = ColumnProfile(
                table=name, column=c, dtype="int", rows=rows,
                non_null=live,
                null_frac=(int(n_null[i]) / rows) if rows else 0.0,
                ndv=ndv,
                ndv_stats=stats.distinct.get(c),
                minmax=mm,
                uniqueness=min(1.0, ndv / live) if live else 0.0,
                density=min(1.0, ndv / width) if width > 0 else 0.0,
            )

    for c in table.column_names():
        if c in profiles:
            continue
        profiles[c] = ColumnProfile(
            table=name, column=c, dtype="float", rows=rows, non_null=rows,
            null_frac=0.0, ndv=0, ndv_stats=None, minmax=None,
            uniqueness=0.0, density=0.0)

    return TableProfile(
        name=name, rows=rows, capacity=table.capacity, columns=profiles,
        stats_fingerprint=stats.fingerprint(),
        profile_s=time.perf_counter() - t0)


def profile_database(db: Database,
                     tables: Optional[Iterable[str]] = None,
                     k: int = SKETCH_K) -> Dict[str, TableProfile]:
    """Profile a set of tables (default: the whole catalog)."""
    names = sorted(db.tables) if tables is None else sorted(set(tables))
    return {n: profile_table(n, db.tables[n], db.stats[n], k=k)
            for n in names}
