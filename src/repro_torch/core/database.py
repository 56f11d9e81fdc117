"""Database instance D = {R_i}: named columnar tables + ANALYZE statistics.

Tables are immutable; *databases* mutate by swapping whole tables in.  The
mutation API (:meth:`Database.insert_rows` / :meth:`Database.delete_rows` /
:meth:`Database.apply_delta`) is the system's change-capture point: every
call appends a signed delta to the table's
:class:`repro_torch.incremental.ChangeLog`, bumps the global ``epoch``, and
updates :class:`TableStats` *incrementally* (row count, min/max,
approximate NDV) instead of re-running a full ANALYZE — the statistics a
continuously-mutating serving database can actually afford.  ``analyze()``
remains the exact recomputation and resets the approximation.

Statistics, exact or incremental, are integer-for-integer those of the JAX
package for the same data and the same mutations — the planner's choices
depend on nothing else.  With a write-ahead log attached
(:meth:`Database.attach_wal`), every mutation is logged before it is
applied, in the JAX package's on-disk format.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.relational import Table
from repro_torch.relational.join import round_capacity
from repro_torch.relational.table import host, resolve_device

Fingerprint = Tuple  # nested tuples, hashable


@dataclasses.dataclass
class TableStats:
    """Optimizer statistics (PostgreSQL-ANALYZE analogue).

    ``distinct`` and ``minmax`` cover int key columns only.  After a
    mutation both are *approximations* (see the ``_stats_after_*``
    helpers); ``analyze()`` restores exact values.
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


def _stats_after_insert(st: TableStats, plus: TableStats) -> TableStats:
    """Fold inserted-row stats in: exact rows, merged min/max, NDV bound.

    NDV is capped at ``old + inserted_distinct`` (exact if the inserted
    values are all new, an over-estimate otherwise) and at the row count.
    """
    rows = st.rows + plus.rows
    distinct = {
        c: min(rows, n + plus.distinct.get(c, 0))
        for c, n in st.distinct.items()
    }
    minmax = dict(st.minmax)
    for c, (lo, hi) in plus.minmax.items():
        if c in minmax:
            minmax[c] = (min(minmax[c][0], lo), max(minmax[c][1], hi))
        else:
            minmax[c] = (lo, hi)
    return TableStats(rows=rows, distinct=distinct, width=st.width,
                      minmax=minmax)


def _stats_after_delete(st: TableStats, minus_rows: int) -> TableStats:
    """Scale NDV with the surviving fraction (uniform-deletion model).

    Min/max stay put while rows survive — deletion can only shrink the
    true range, so the stored range remains a valid (conservative) bound.
    When the table empties, the old range bounds nothing: minmax is
    cleared and NDV drops to 0, so a later insert re-seeds both from the
    inserted rows alone instead of inheriting stale extrema.  Python's
    ``round`` (half to even), as in the JAX package: one NDV off would
    plan differently.
    """
    rows = max(0, st.rows - minus_rows)
    if rows == 0:
        return TableStats(rows=0, distinct={c: 0 for c in st.distinct},
                          width=st.width, minmax={})
    frac = rows / st.rows
    distinct = {c: max(1, min(rows, int(round(n * frac))))
                for c, n in st.distinct.items()}
    return TableStats(rows=rows, distinct=distinct, width=st.width,
                      minmax=dict(st.minmax))


RowsLike = Union[Table, Mapping[str, object]]


def _host_array(v) -> np.ndarray:
    return host(v) if isinstance(v, torch.Tensor) else np.asarray(v)


class Database:
    """Named tables + stats; views are added at plan-execution time.

    ``epoch`` counts mutations (one per :meth:`apply_delta` /
    :meth:`insert_rows` / :meth:`delete_rows` call); ``changelog`` maps
    each mutated table to its :class:`~repro_torch.incremental.ChangeLog`.
    Replacing a table wholesale (:meth:`add_table`) is *not* change
    capture: it resets that table's history, so delta consumers holding an
    older cursor fall back to full recomputation.  Mutated tables stay on
    the device of the table they replace.
    """

    def __init__(self, tables: Optional[Dict[str, Table]] = None, *,
                 durable_dir: Optional[str] = None):
        self.tables: Dict[str, Table] = dict(tables or {})
        self.stats: Dict[str, TableStats] = {}
        self.epoch: int = 0
        self.changelog: Dict[str, "ChangeLog"] = {}
        self._wal = None
        for name in self.tables:
            self.analyze(name)
        if durable_dir is not None:
            self.attach_wal(durable_dir)

    @property
    def device(self) -> Optional[torch.device]:
        """Where the tables live (``None`` for an empty database)."""
        for t in self.tables.values():
            return t.device
        return None

    # -- durability ----------------------------------------------------------
    @property
    def wal(self):
        """The attached write-ahead log, or ``None`` (in-memory only)."""
        return self._wal

    def attach_wal(self, wal_or_dir) -> "object":
        """Make this database durable: every mutation is WAL'd first.

        Accepts a directory path or a ready
        :class:`~repro_torch.durability.wal.WriteAheadLog`.  The WAL append
        is the commit point — if it raises, the in-memory tables, stats,
        changelog, and epoch are all left untouched, so a failed durable
        write can simply be retried.
        """
        from repro_torch.durability.wal import WriteAheadLog

        if isinstance(wal_or_dir, WriteAheadLog):
            self._wal = wal_or_dir
        else:
            self._wal = WriteAheadLog(str(wal_or_dir))
        return self._wal

    def detach_wal(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def add_table(self, name: str, table: Table, analyze: bool = True):
        replacing = name in self.tables
        if self._wal is not None:
            # wholesale replacement must be durable too: log the full new
            # table *before* binding it.  A durable database stamps every
            # add with an epoch (even a fresh name, which in-memory-only
            # databases do not count) so WAL records stay strictly ordered.
            self._wal.append_replace(
                name, self.epoch + 1, table.to_numpy(),
                capacity=table.capacity, replacing=replacing)
        self.tables[name] = table
        if replacing or self._wal is not None:
            self.epoch += 1
        if replacing:
            # wholesale replacement is not change capture: it invalidates
            # the delta history, so cursors from before it stop being
            # serviceable and refresh consumers take the full path
            from repro_torch.incremental.changelog import ChangeLog

            self.changelog.setdefault(name, ChangeLog()).prune(self.epoch)
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

    # -- mutation API (change capture) ---------------------------------------
    def _as_rows_table(self, name: str, rows: RowsLike) -> Table:
        """Normalize inserted/deleted rows to a compact, schema-checked
        Table on the base table's device, in its column dtypes."""
        base = self.tables[name]
        if isinstance(rows, Table):
            data = rows.to_numpy()
        else:
            data = {k: _host_array(v) for k, v in rows.items()}
        if set(data) != set(base.column_names()):
            raise ValueError(
                f"delta columns {sorted(data)} != table columns "
                f"{list(base.column_names())} for {name!r}")
        cols = {}
        for c in base.column_names():
            dtype = torch.empty(0, dtype=base[c].dtype).numpy().dtype
            cols[c] = torch.from_numpy(
                np.ascontiguousarray(data[c].astype(dtype))).to(base.device)
        return Table.from_arrays(device=base.device, **cols)

    def _log(self, name: str, plus: Optional[Table], minus: Optional[Table],
             plus_count: int, minus_count: int) -> "TableDelta":
        from repro_torch.incremental.changelog import ChangeLog, TableDelta

        entry = TableDelta(epoch=self.epoch + 1, plus=plus, minus=minus,
                           plus_count=plus_count, minus_count=minus_count)
        if self._wal is not None:
            # the durability point: if the append raises, no in-memory
            # state has moved — the caller may retry the whole mutation
            self._wal.append_delta(name, entry)
        self.epoch += 1
        self.changelog.setdefault(name, ChangeLog()).append(entry)
        return entry

    def apply_delta(self, name: str, plus: Optional[RowsLike] = None,
                    minus=None) -> "TableDelta":
        """Apply one signed delta to ``name``: delete ``minus``, insert ``plus``.

        ``minus`` is a boolean mask over the table's capacity, an integer
        array of row slots, or a rows-like bag of rows to cancel (each minus row invalidates one matching valid row — bag
        semantics).  ``plus`` is a rows-like with the table's exact column
        set.  One changelog entry (one epoch) is appended; table stats
        update incrementally.
        """
        from repro_torch.relational.ops import subtract_bag

        base = self.tables[name]
        st = self.stats[name]
        dev = base.device
        minus_table: Optional[Table] = None
        cur = base

        if minus is not None:
            if isinstance(minus, np.ndarray):
                if minus.dtype.kind in "iu":      # row-slot indices -> mask
                    idx = minus
                    minus = np.zeros((base.capacity,), dtype=bool)
                    minus[idx] = True
                elif minus.dtype != bool:
                    raise ValueError(
                        f"minus array must be a bool mask or integer row "
                        f"indices, got dtype {minus.dtype}")
            if isinstance(minus, np.ndarray):
                if minus.shape != (base.capacity,):
                    raise ValueError(
                        f"delete mask shape {minus.shape} != "
                        f"({base.capacity},)")
                del_mask = base.valid & torch.from_numpy(minus).to(dev)
                removed = del_mask
                cur = base.mask(~del_mask)
            else:
                requested = self._as_rows_table(name, minus)
                cur = subtract_bag(base, requested)
                # log only the rows actually cancelled — a minus row with
                # no match deletes nothing, and recording it would feed a
                # phantom row into the IVM minus terms and break the
                # refresh parity guarantee
                removed = base.valid & ~cur.valid
            n_minus = int(removed.sum())
            if n_minus:
                minus_table = Table.from_arrays(
                    device=dev,
                    **{c: base[c][removed] for c in base.column_names()})
                st = _stats_after_delete(st, n_minus)
        else:
            n_minus = 0

        plus_table: Optional[Table] = None
        if plus is not None:
            plus_table = self._as_rows_table(name, plus)
            n_plus = int(plus_table.capacity)
            if n_plus:
                valid = cur.valid
                cols = {c: torch.cat([cur[c][valid], plus_table[c]])
                        for c in cur.column_names()}
                n_rows = int(valid.sum()) + n_plus
                cur = Table.from_arrays(capacity=round_capacity(n_rows),
                                        device=dev, **cols)
                st = _stats_after_insert(st, compute_stats(plus_table))
            else:
                plus_table = None
        else:
            n_plus = 0

        if plus is None and minus is None:
            raise ValueError("apply_delta with neither rows to insert "
                             "nor rows to delete")
        if plus_table is None and minus_table is None:
            return self._log(name, None, None, 0, 0)  # empty delta: epoch only
        # _log first: it holds the WAL commit point, and the table/stats
        # swap below must not happen if durability was refused
        entry = self._log(name, plus_table, minus_table, n_plus, n_minus)
        self.tables[name] = cur
        self.stats[name] = st
        return entry

    def insert_rows(self, name: str, **columns) -> "TableDelta":
        """Append rows (one array per column) to ``name``; change-captured."""
        return self.apply_delta(name, plus=columns)

    def delete_rows(self, name: str, mask) -> "TableDelta":
        """Delete valid rows by capacity-aligned bool mask or row indices."""
        mask = host(mask) if isinstance(mask, torch.Tensor) \
            else np.asarray(mask)
        return self.apply_delta(name, minus=mask)

    def delete_where(self, name: str, col: str, op: str,
                     value) -> "TableDelta":
        """Delete valid rows matching ``col op value`` (predicate CDC).

        Compared on a host copy in numpy, as the reference does: a Python
        int outside the column's type compares exactly (torch would wrap
        it to int32)."""
        from repro_torch.relational.ops import _OPS

        arr = host(self.tables[name][col])
        return self.delete_rows(name, np.asarray(_OPS[op](arr, value)))

    def deltas_since(self, name: str, epoch: int):
        """Changelog entries for ``name`` strictly after ``epoch``."""
        log = self.changelog.get(name)
        if log is None:
            return []
        return log.since(epoch)

    def covers_epoch(self, name: str, epoch: int) -> bool:
        """True iff delta history for ``name`` reaches back to ``epoch``."""
        log = self.changelog.get(name)
        return True if log is None else log.covers(epoch)

    def prune_changelog(self, before_epoch: int) -> int:
        """Discard delta history at or below ``before_epoch``; returns #dropped.

        Consumers whose cursor predates the prune point detect it via
        :meth:`covers_epoch` and fall back to full recomputation.
        """
        return sum(log.prune(before_epoch)
                   for log in self.changelog.values())

    # -- snapshots / digests -------------------------------------------------
    def snapshot(self) -> "Database":
        """Shallow per-request copy: shared column tensors, private catalogs.

        Views registered on (and stats re-analyzed in) the snapshot never
        leak back into this database, and mutations applied to either side
        after the split never reach the other — tables, stats objects, and
        changelog entry lists are all private (the underlying immutable
        tensors and delta entries are shared).  The clone never inherits
        the WAL: only the live database writes durable history.
        """
        clone = Database()
        clone.tables = dict(self.tables)
        clone.stats = dict(self.stats)
        clone.epoch = self.epoch
        clone.changelog = {n: log.copy() for n, log in self.changelog.items()}
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
