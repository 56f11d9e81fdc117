"""Database instance D = {R_i}: named columnar tables + ANALYZE statistics.

Tables are immutable; *databases* change by swapping whole tables in.
Statistics are exact ANALYZE passes over the host copy of each table, so
they are integer-for-integer those of the JAX package for the same data —
the planner's choices depend on nothing else.

The change-capture API (row inserts/deletes with a changelog and a WAL)
belongs to the incremental and durability layers, which this package does
not have yet: with no changelog, every table's delta history is empty and
covers every epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.relational import Table
from repro_torch.relational.table import host, resolve_device

Fingerprint = Tuple  # nested tuples, hashable


@dataclasses.dataclass
class TableStats:
    """Optimizer statistics (PostgreSQL-ANALYZE analogue).

    ``distinct`` and ``minmax`` cover int key columns only.
    """

    rows: int
    distinct: Dict[str, int]
    width: int  # columns (4 bytes each, all int32/float32)
    minmax: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)

    def bytes(self) -> int:
        return self.rows * self.width * 4

    def ndv(self, col: str) -> int:
        return max(1, self.distinct.get(col, self.rows))

    def fingerprint(self) -> Fingerprint:
        """Hashable digest of these stats (cache-invalidation token)."""
        return (self.rows, self.width, tuple(sorted(self.distinct.items())),
                tuple(sorted(self.minmax.items())))


def compute_stats(t: Table) -> TableStats:
    """Exact ANALYZE pass over one table (on a host copy of its columns)."""
    valid = host(t.valid)
    rows = int(valid.sum())
    distinct: Dict[str, int] = {}
    minmax: Dict[str, Tuple[int, int]] = {}
    for col in t.column_names():
        arr = host(t[col])
        if arr.dtype.kind in "iu":
            live = arr[valid]
            distinct[col] = int(np.unique(live).size)
            if live.size:
                minmax[col] = (int(live.min()), int(live.max()))
    return TableStats(rows=rows, distinct=distinct,
                      width=len(t.column_names()), minmax=minmax)


class Database:
    """Named tables + stats; views are added at plan-execution time.

    ``epoch`` counts wholesale table replacements (:meth:`add_table` of an
    existing name).
    """

    def __init__(self, tables: Optional[Dict[str, Table]] = None):
        self.tables: Dict[str, Table] = dict(tables or {})
        self.stats: Dict[str, TableStats] = {}
        self.epoch: int = 0
        for name in self.tables:
            self.analyze(name)

    @property
    def device(self) -> Optional[torch.device]:
        """Where the tables live (``None`` for an empty database)."""
        for t in self.tables.values():
            return t.device
        return None

    def add_table(self, name: str, table: Table, analyze: bool = True):
        replacing = name in self.tables
        self.tables[name] = table
        if replacing:
            self.epoch += 1
        if analyze:
            self.analyze(name)

    def add_view(self, name: str, table: Table, stats: TableStats):
        """Views carry estimated stats (no ANALYZE pass: that's the point)."""
        self.tables[name] = table
        self.stats[name] = stats

    def table(self, name: str) -> Table:
        return self.tables[name]

    def analyze(self, name: str) -> TableStats:
        st = compute_stats(self.tables[name])
        self.stats[name] = st
        return st

    def deltas_since(self, name: str, epoch: int):
        """Changelog entries for ``name`` strictly after ``epoch`` (none)."""
        return []

    def covers_epoch(self, name: str, epoch: int) -> bool:
        """True iff delta history for ``name`` reaches back to ``epoch``."""
        return True

    # -- snapshots / digests -------------------------------------------------
    def snapshot(self) -> "Database":
        """Shallow per-request copy: shared column tensors, private catalogs.

        Views registered on (and stats re-analyzed in) the snapshot never
        leak back into this database.
        """
        clone = Database()
        clone.tables = dict(self.tables)
        clone.stats = dict(self.stats)
        clone.epoch = self.epoch
        return clone

    def fingerprint(self, tables: Optional[Iterable[str]] = None
                    ) -> Fingerprint:
        """Digest of the catalog's stats; changes when stats do.

        ``tables`` restricts the digest to a subset — the engine keys plan
        cache entries by the fingerprint of only the tables a model reads,
        so unrelated churn cannot invalidate them.  Names without stats
        (never analyzed) contribute a ``None`` marker rather than raising.
        """
        if tables is None:
            items = sorted(self.stats.items())
            return tuple((name, st.fingerprint()) for name, st in items)
        out = []
        for name in sorted(set(tables)):
            st = self.stats.get(name)
            out.append((name, None if st is None else st.fingerprint()))
        return tuple(out)

    def total_bytes(self) -> int:
        return sum(s.bytes() for s in self.stats.values())


def from_numpy_tables(tables: Mapping[str, Mapping[str, np.ndarray]],
                      device=None) -> Database:
    """A database from host arrays: ``{name: {col: array, "valid": mask}}``.

    Capacity, padding and dtypes are kept as given (the arrays may come
    from another implementation's database, e.g. ``np.asarray`` of each
    column); every table is re-analyzed.  ``device=None`` means the CUDA
    card.
    """
    dev = resolve_device(device)
    db = Database()
    for name, cols in tables.items():
        cols = dict(cols)
        valid = np.array(cols.pop("valid"), dtype=bool)
        db.add_table(name, Table(
            columns={k: torch.from_numpy(np.array(v)).to(dev)
                     for k, v in cols.items()},
            valid=torch.from_numpy(valid).to(dev)))
    return db
