"""Epoch-based MVCC snapshots over :class:`repro_torch.api.ExtractionEngine`.

A *snapshot* is one published epoch of the served database: an immutable
``Database`` snapshot plus a private engine over it (seeded by
:meth:`ExtractionEngine.fork`, so it is cache-warm from birth).  The store
holds every snapshot still referenced:

* **Readers** ``pin()`` an epoch (default: latest) and serve every lookup
  from that snapshot's engine.  The pinned database never mutates, so two
  reads of one epoch are bit-identical — whatever writers do meanwhile.
* **The writer** builds the *next* epoch completely off to the side
  (fork over a fresh ``db.snapshot()``, refresh every registered model)
  and then :meth:`publish`\\ es it — a single reference swap under the
  store lock.  Readers never take the build lock and never observe a
  half-built epoch; pinned readers keep their old snapshot alive until
  they unpin.

Retirement is refcounted: an unpinned snapshot older than ``keep``
published epochs is dropped; a pinned one survives until its last reader
releases it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

from repro_torch.api.engine import ExtractionEngine
from repro_torch.core.database import Database
from repro_torch.durability import faults


@dataclasses.dataclass
class Snapshot:
    """One published epoch: frozen database + cache-warm engine over it."""

    epoch: int
    db: Database
    engine: ExtractionEngine
    published_at: float = dataclasses.field(default_factory=time.monotonic)
    pins: int = 0          # managed by SnapshotStore under its lock
    retired: bool = False  # no longer current; dropped once pins hit 0


class SnapshotNotFound(KeyError):
    """The requested epoch was never published or has been retired."""

    def __init__(self, epoch: int, available: List[int]):
        super().__init__(epoch)
        self.epoch = epoch
        self.available = available

    def __str__(self) -> str:
        return (f"epoch {self.epoch} is not served "
                f"(available: {self.available})")


class SnapshotStore:
    """Refcounted registry of published epochs with atomic swap.

    ``keep`` bounds how many *unpinned* non-current epochs linger for
    late-arriving pinned readers; pinned epochs are never dropped.
    """

    def __init__(self, first: Snapshot, keep: int = 2):
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._current = first
        self._snapshots: Dict[int, Snapshot] = {first.epoch: first}
        self._order: List[int] = [first.epoch]   # publish order
        self.published = 1
        self.dropped = 0

    # -- read side -----------------------------------------------------------
    def current_epoch(self) -> int:
        with self._lock:
            return self._current.epoch

    def epochs(self) -> List[int]:
        with self._lock:
            return sorted(self._snapshots)

    @contextlib.contextmanager
    def pin(self, epoch: Optional[int] = None) -> Iterator[Snapshot]:
        """Borrow a snapshot for the duration of the ``with`` block.

        ``epoch=None`` pins the latest published epoch.  While pinned the
        snapshot cannot be retired, so every read through it is isolated
        from concurrent publishes.
        """
        with self._lock:
            if epoch is None:
                snap = self._current
            else:
                snap = self._snapshots.get(int(epoch))
                if snap is None:
                    raise SnapshotNotFound(int(epoch),
                                           sorted(self._snapshots))
            snap.pins += 1
        try:
            yield snap
        finally:
            with self._lock:
                snap.pins -= 1
                self._retire_locked()

    # -- write side ----------------------------------------------------------
    def publish(self, snap: Snapshot) -> Snapshot:
        """Atomically make ``snap`` the current epoch; returns it.

        Re-publishing an epoch that is already current is a no-op (the
        existing snapshot stays, so its warmed caches are not thrown away).
        """
        # fault site fires before any store state moves: an injected
        # publish failure leaves the previous epoch fully intact
        faults.fire("snapshot.publish")
        with self._lock:
            if snap.epoch == self._current.epoch:
                return self._current
            if snap.epoch in self._snapshots:
                raise ValueError(
                    f"epoch {snap.epoch} already published (non-current); "
                    "epochs must advance monotonically")
            self._current.retired = True
            self._snapshots[snap.epoch] = snap
            self._order.append(snap.epoch)
            self._current = snap
            self.published += 1
            self._retire_locked()
            return snap

    def _retire_locked(self) -> None:
        # oldest-first: drop retired, unpinned epochs beyond the keep window
        removable = [e for e in self._order
                     if e in self._snapshots
                     and self._snapshots[e].retired
                     and self._snapshots[e].pins == 0]
        excess = len(removable) - self.keep
        for e in removable[:max(0, excess)]:
            del self._snapshots[e]
            self.dropped += 1
        self._order = [e for e in self._order if e in self._snapshots]

    def pinned_epochs(self) -> List[int]:
        """Epochs currently borrowed by at least one reader.

        The pin-leak invariant of the serving layer: after every request
        settles — success, worker raise, deadline expiry, injected publish
        failure — this must drain back to ``[]``.
        """
        with self._lock:
            return sorted(e for e, s in self._snapshots.items() if s.pins)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "current_epoch": self._current.epoch,
                "epochs": sorted(self._snapshots),
                "pins": {e: s.pins for e, s in self._snapshots.items()
                         if s.pins},
                "pinned_epochs": sorted(e for e, s in self._snapshots.items()
                                        if s.pins),
                "published": self.published,
                "dropped": self.dropped,
            }
