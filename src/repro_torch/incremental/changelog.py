"""Change capture: per-table logs of signed delta tables (CDC analogue).

Every mutation of a :class:`repro_torch.core.database.Database` table
appends one :class:`TableDelta` — an inserted-rows table (``plus``) and/or
a deleted-rows table (``minus``) — to that table's :class:`ChangeLog` and
bumps the database's global ``epoch``.  Consumers (the engine's
``refresh()``, view maintenance) record the epoch their cached state was
built at and later ask for :func:`merge_deltas` of everything since; the
merged delta satisfies the bag identity

    new(T)  ==  old(T)  ⊎  plus  ∖  minus

which is exactly what the join-differentiation rule in
:mod:`repro_torch.incremental.delta` consumes.  A row inserted *and*
deleted after the cursor appears in both sides and cancels during
application (plus is always applied before minus), so interleaved mutation
histories merge correctly without per-entry replay.

Delta tables live on the device of the table they change; merging folds
them on the host (as the JAX package does) and puts the result back there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.relational import Table
from repro_torch.relational.join import round_capacity


@dataclasses.dataclass(frozen=True)
class TableDelta:
    """One mutation of one table: signed row sets plus the epoch stamp.

    ``plus`` / ``minus`` are ordinary :class:`Table` objects holding only
    the affected rows (all slots valid); either may be ``None``.  Row
    counts are recorded host-side at mutation time so churn accounting
    never needs a device sync.
    """

    epoch: int
    plus: Optional[Table] = None
    minus: Optional[Table] = None
    plus_count: int = 0
    minus_count: int = 0

    @property
    def rows_changed(self) -> int:
        return self.plus_count + self.minus_count


class ChangeLog:
    """Append-only mutation history of one table.

    ``base_epoch`` is the epoch before which history has been discarded
    (:meth:`prune`); :meth:`covers` tells a consumer whether its cursor is
    still serviceable or it must fall back to a full recomputation.
    """

    def __init__(self, base_epoch: int = 0):
        self.base_epoch = base_epoch
        self.entries: List[TableDelta] = []

    def append(self, entry: TableDelta) -> None:
        self.entries.append(entry)

    def since(self, epoch: int) -> List[TableDelta]:
        """Entries strictly after ``epoch`` (the consumer's cursor)."""
        return [e for e in self.entries if e.epoch > epoch]

    def covers(self, epoch: int) -> bool:
        return epoch >= self.base_epoch

    def rows_changed_since(self, epoch: int) -> int:
        return sum(e.rows_changed for e in self.since(epoch))

    def prune(self, before_epoch: int) -> int:
        """Drop entries at or below ``before_epoch``; returns #dropped.

        Raises ``base_epoch`` so :meth:`covers` rejects cursors older than
        the surviving history (they must take the full-recompute path).
        """
        kept = [e for e in self.entries if e.epoch > before_epoch]
        dropped = len(self.entries) - len(kept)
        self.entries = kept
        self.base_epoch = max(self.base_epoch, before_epoch)
        return dropped

    def copy(self) -> "ChangeLog":
        """Snapshot copy: private entry list, shared immutable deltas."""
        clone = ChangeLog(self.base_epoch)
        clone.entries = list(self.entries)
        return clone


@dataclasses.dataclass(frozen=True)
class MergedDelta:
    """Every entry since a cursor, folded into one signed delta.

    ``plus`` / ``minus`` are compacted to valid-prefix tables padded to a
    pow-2 capacity, so repeated refreshes at similar churn reuse the same
    unit functions (the delta-pipeline unit-cache contract).
    """

    plus: Optional[Table] = None
    minus: Optional[Table] = None
    plus_count: int = 0
    minus_count: int = 0

    @property
    def empty(self) -> bool:
        return self.plus_count == 0 and self.minus_count == 0

    @property
    def rows_changed(self) -> int:
        return self.plus_count + self.minus_count


def _concat_rows(tables: Sequence[Table]) -> Tuple[Optional[Table], int]:
    """Host-side concat of the valid rows of ``tables``, pow-2 padded,
    back on the first table's device."""
    datas = [t.to_numpy() for t in tables]
    total = sum(len(next(iter(d.values()))) for d in datas) if datas else 0
    if total == 0:
        return None, 0
    names = list(datas[0])
    cols = {n: np.concatenate([d[n] for d in datas]) for n in names}
    return Table.from_arrays(capacity=round_capacity(total),
                             device=tables[0].device, **cols), total


def merge_deltas(entries: Sequence[TableDelta]) -> MergedDelta:
    """Fold a list of changelog entries into one signed delta."""
    plus, n_plus = _concat_rows([e.plus for e in entries if e.plus is not None])
    minus, n_minus = _concat_rows(
        [e.minus for e in entries if e.minus is not None])
    return MergedDelta(plus=plus, minus=minus,
                       plus_count=n_plus, minus_count=n_minus)


# -- WAL serialization --------------------------------------------------------
# A TableDelta round-trips through a flat {"plus/<col>": array,
# "minus/<col>": array} mapping — exactly the shape ``np.savez`` wants, so
# the write-ahead log can persist deltas without a pickle anywhere.  The
# keys and dtypes are the JAX package's: a log written by either package
# replays in the other.

def delta_to_payload(entry: TableDelta) -> Dict[str, np.ndarray]:
    """Flatten a delta's signed row sets into npz-ready keyed arrays."""
    out: Dict[str, np.ndarray] = {}
    if entry.plus is not None:
        for col, arr in entry.plus.to_numpy().items():
            out[f"plus/{col}"] = arr
    if entry.minus is not None:
        for col, arr in entry.minus.to_numpy().items():
            out[f"minus/{col}"] = arr
    return out


def payload_to_rows(payload: Mapping[str, np.ndarray], side: str
                    ) -> Optional[Dict[str, np.ndarray]]:
    """One signed side (``"plus"``/``"minus"``) of a flattened payload."""
    prefix = side + "/"
    cols = {k[len(prefix):]: np.asarray(v) for k, v in payload.items()
            if k.startswith(prefix)}
    return cols or None


def delta_from_payload(epoch: int, payload: Mapping[str, np.ndarray],
                       device=None) -> TableDelta:
    """Inverse of :func:`delta_to_payload` (bag-identical, all-valid rows).

    ``device=None`` places the row tables on the CUDA card.
    """
    sides: Dict[str, Optional[Table]] = {}
    counts: Dict[str, int] = {}
    for side in ("plus", "minus"):
        cols = payload_to_rows(payload, side)
        if cols is None:
            sides[side], counts[side] = None, 0
            continue
        n = len(next(iter(cols.values())))
        sides[side] = Table.from_arrays(device=device, **cols) if n else None
        counts[side] = n if sides[side] is not None else 0
    return TableDelta(epoch=epoch, plus=sides["plus"], minus=sides["minus"],
                      plus_count=counts["plus"], minus_count=counts["minus"])
