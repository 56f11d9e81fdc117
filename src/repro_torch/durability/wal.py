"""Crash-safe write-ahead log for :class:`~repro_torch.core.database.Database`.

The durability point of the serving stack: every change-captured mutation
appends one checksummed record *before* the in-memory commit, so a crash
at any instant leaves the log a strict prefix of the accepted history —
replaying it reproduces the exact table bags (and, because the stats
arithmetic in ``core.database`` is deterministic, the exact incremental
statistics) the process held when it died.  The format is the JAX
package's byte for byte in structure (header, npz payload keys, CRC), so a
log written by either package replays in the other.

On-disk layout (one directory)::

    wal-<start:012d>.open                 active segment (append + fsync)
    wal-<start:012d>-<end:012d>.seg       sealed segment (epochs start..end)

Record format (little-endian)::

    b"WALR" | u32 total_len | u32 crc32 | u32 header_len
    header_len bytes of JSON header | (total_len - header_len) npz payload

* ``crc32`` covers header + payload; ``total_len`` bounds the read — a
  record that fails either check in the **active** segment is a torn tail
  (the crash interrupted the write) and is truncated away on replay; the
  same failure in a **sealed** segment is real corruption and raises
  :class:`WALCorruption`.
* The payload is a pickle-free ``.npz``: ``plus/<col>`` / ``minus/<col>``
  arrays for delta records, ``table/<col>`` for wholesale replacement.
* Segments seal by atomic rename (``.open`` → ``-<end>.seg``) once they
  exceed ``segment_bytes``; :meth:`prune` deletes sealed segments whose
  end epoch is covered by a published checkpoint — the pruning gate that
  keeps "no manifest ⇒ full replay from base" a valid invariant.

Fault sites (see :mod:`repro_torch.durability.faults`): ``wal.append`` (raise or
partial write), ``wal.fsync``, ``wal.rename``.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.durability import faults
from repro_torch.incremental.changelog import TableDelta, delta_to_payload
from repro_torch.obs.metrics import failure_counter

log = logging.getLogger("repro_torch.durability")

MAGIC = b"WALR"
_PREFIX = struct.Struct("<4sIII")          # magic, total_len, crc32, header_len
_MAX_RECORD = 1 << 31                      # sanity bound on total_len

_OPEN_RE = re.compile(r"^wal-(\d{12})\.open$")
_SEG_RE = re.compile(r"^wal-(\d{12})-(\d{12})\.seg$")


class WALError(RuntimeError):
    pass


class WALCorruption(WALError):
    """A sealed segment failed its checksum — not a torn tail."""


@dataclasses.dataclass
class WALRecord:
    """One replayed record: the mutation exactly as it was accepted."""

    table: str
    kind: str                  # "delta" | "replace" | "empty"
    epoch: int
    payload: Dict[str, np.ndarray]
    plus_count: int = 0
    minus_count: int = 0
    capacity: Optional[int] = None     # replace records: original capacity
    replacing: bool = True             # replace records: was the name bound?


def _encode(header: Dict[str, object],
            arrays: Dict[str, np.ndarray]) -> bytes:
    head = json.dumps(header, sort_keys=True).encode()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    body = head + payload
    return _PREFIX.pack(MAGIC, len(body), zlib.crc32(body) & 0xFFFFFFFF,
                        len(head)) + body


def _decode_at(data: bytes, off: int) -> Tuple[Optional[WALRecord], int]:
    """Parse one record at ``off``; ``(None, off)`` marks a bad/torn tail."""
    if off + _PREFIX.size > len(data):
        return None, off
    magic, total_len, crc, header_len = _PREFIX.unpack_from(data, off)
    if (magic != MAGIC or header_len > total_len
            or total_len > _MAX_RECORD):
        return None, off
    end = off + _PREFIX.size + total_len
    if end > len(data):
        return None, off
    body = data[off + _PREFIX.size:end]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        return None, off
    header = json.loads(body[:header_len].decode())
    payload: Dict[str, np.ndarray] = {}
    raw = body[header_len:]
    if raw:
        with np.load(io.BytesIO(raw)) as npz:
            payload = {k: npz[k] for k in npz.files}
    rec = WALRecord(
        table=header["table"], kind=header["kind"],
        epoch=int(header["epoch"]),
        payload=payload,
        plus_count=int(header.get("plus", 0)),
        minus_count=int(header.get("minus", 0)),
        capacity=header.get("capacity"),
        replacing=bool(header.get("replacing", True)))
    return rec, end


def _segments(path: str) -> Tuple[List[Tuple[int, int, str]], Optional[str]]:
    """``(sealed [(start, end, name)] sorted, active-name-or-None)``."""
    sealed: List[Tuple[int, int, str]] = []
    active: Optional[str] = None
    for name in os.listdir(path):
        m = _SEG_RE.match(name)
        if m:
            sealed.append((int(m.group(1)), int(m.group(2)), name))
            continue
        if _OPEN_RE.match(name):
            if active is not None:
                raise WALError(f"two active WAL segments in {path!r}: "
                               f"{active}, {name}")
            active = name
    sealed.sort()
    return sealed, active


def _scan_file(raw: bytes, *, sealed: bool, name: str
               ) -> Tuple[List[WALRecord], int]:
    """All good records plus the byte offset where the good prefix ends."""
    records: List[WALRecord] = []
    off = 0
    while off < len(raw):
        rec, end = _decode_at(raw, off)
        if rec is None:
            if sealed:
                raise WALCorruption(
                    f"corrupt record at offset {off} of sealed "
                    f"segment {name!r}")
            break
        records.append(rec)
        off = end
    return records, off


def read_all(path: str, *, repair: bool = True
             ) -> Tuple[List[WALRecord], int]:
    """Every record in epoch order, repairing a torn active tail.

    Returns ``(records, truncated_bytes)``.  With ``repair`` (the replay
    default) a torn/checksum-failed tail of the *active* segment is
    physically truncated away so later appends start from the last good
    record — in a sealed segment the same damage raises
    :class:`WALCorruption` instead.
    """
    if not os.path.isdir(path):
        return [], 0
    sealed, active = _segments(path)
    records: List[WALRecord] = []
    for _, _, name in sealed:
        with open(os.path.join(path, name), "rb") as f:
            recs, _ = _scan_file(f.read(), sealed=True, name=name)
        records.extend(recs)
    truncated = 0
    if active is not None:
        full = os.path.join(path, active)
        with open(full, "rb") as f:
            raw = f.read()
        recs, good = _scan_file(raw, sealed=False, name=active)
        records.extend(recs)
        if good < len(raw):
            truncated = len(raw) - good
            log.warning(
                "WAL %s: torn tail in %s — truncating %d bytes after "
                "%d good records", path, active, truncated, len(recs))
            failure_counter("durability_wal_truncated_records_total").inc()
            if repair:
                with open(full, "r+b") as f:
                    f.truncate(good)
    return records, truncated


class WriteAheadLog:
    """Appender over a WAL directory (one per durable database).

    Opening scans existing segments (repairing a torn active tail) and
    resumes appending to the active segment, so restart + attach is safe
    without any copy.  ``fsync=False`` trades durability for test speed.
    """

    def __init__(self, path: str, *, segment_bytes: int = 4 << 20,
                 fsync: bool = True):
        self.path = path
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        os.makedirs(path, exist_ok=True)
        self.appended = 0
        self.rotations = 0
        self.pruned = 0
        self._f = None                    # active segment file object
        self._active_name: Optional[str] = None
        self._active_size = 0
        self._last_epoch = 0
        self._torn = False                # partial-write fault left a tail
        sealed, active = _segments(path)
        if sealed:
            self._last_epoch = sealed[-1][1]
        if active is not None:
            full = os.path.join(path, active)
            with open(full, "rb") as f:
                recs, good = _scan_file(f.read(), sealed=False, name=active)
            if good < os.path.getsize(full):
                log.warning("WAL %s: truncating torn tail of %s on open",
                            path, active)
                with open(full, "r+b") as f:
                    f.truncate(good)
            if recs:
                self._last_epoch = max(self._last_epoch, recs[-1].epoch)
            self._active_name = active
            self._active_size = good
            self._f = open(full, "ab")

    # -- appending -----------------------------------------------------------
    def append_delta(self, table: str, entry: TableDelta) -> None:
        """Persist one change-captured delta (the durability point)."""
        kind = "empty" if (entry.plus is None and entry.minus is None) \
            else "delta"
        header = {"table": table, "kind": kind, "epoch": entry.epoch,
                  "plus": entry.plus_count, "minus": entry.minus_count}
        self._append(header, delta_to_payload(entry))

    def append_replace(self, table: str, epoch: int, arrays: Dict[str, np.ndarray],
                       capacity: int, replacing: bool = True) -> None:
        """Persist a wholesale table replacement (``Database.add_table``)."""
        header = {"table": table, "kind": "replace", "epoch": epoch,
                  "capacity": int(capacity), "replacing": bool(replacing)}
        self._append(header, {f"table/{c}": a for c, a in arrays.items()})

    def _append(self, header: Dict[str, object],
                arrays: Dict[str, np.ndarray]) -> None:
        epoch = int(header["epoch"])
        if epoch <= self._last_epoch:
            raise WALError(
                f"non-monotonic WAL append: epoch {epoch} after "
                f"{self._last_epoch}")
        faults.fire("wal.append")
        record = _encode(header, arrays)
        self._ensure_active(epoch, len(record))
        frac = faults.partial("wal.append")
        if frac is not None:
            # a crash mid-write: flush a strict prefix, then fail the
            # mutation.  The torn bytes stay on disk — exactly what replay's
            # torn-tail truncation exists to clean up.
            self._f.write(record[:int(len(record) * frac)])
            self._f.flush()
            self._torn = True
            raise faults.FaultInjected("wal.append", "partial record write")
        self._f.write(record)
        self._f.flush()
        try:
            faults.fire("wal.fsync")
            if self.fsync:
                os.fsync(self._f.fileno())
        except faults.FaultInjected:
            # the record reached the OS but the caller will see a failed
            # mutation and keep its old in-memory state — roll the bytes
            # back so disk and memory cannot disagree about epoch N.
            self._f.truncate(self._active_size)
            self._f.seek(0, os.SEEK_END)
            raise
        self._active_size += len(record)
        self._last_epoch = epoch
        self.appended += 1
        failure_counter("durability_wal_records_total",
                        kind=str(header["kind"])).inc()

    def _ensure_active(self, epoch: int, incoming: int) -> None:
        if self._f is not None and getattr(self, "_torn", False):
            # a previous partial-write fault left torn bytes: cut back to
            # the last good record before appending anything new
            self._f.truncate(self._active_size)
            self._f.seek(0, os.SEEK_END)
            self._torn = False
        if (self._f is not None and self._active_size > 0
                and self._active_size + incoming > self.segment_bytes):
            self._seal()
        if self._f is None:
            self._active_name = f"wal-{epoch:012d}.open"
            self._f = open(os.path.join(self.path, self._active_name), "ab")
            self._active_size = 0

    # -- rotation / pruning --------------------------------------------------
    def _seal(self) -> None:
        assert self._f is not None
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        src = os.path.join(self.path, self._active_name)
        start = int(_OPEN_RE.match(self._active_name).group(1))
        dst = os.path.join(
            self.path, f"wal-{start:012d}-{self._last_epoch:012d}.seg")
        try:
            faults.fire("wal.rename")
            os.replace(src, dst)
            self._sync_dir()
        except BaseException:
            # rename refused (e.g. transient I/O error): reopen the active
            # segment so appends keep working; the seal retries at the
            # next rotate().  Without this the WAL would be wedged on a
            # closed file handle.
            self._f = open(src, "ab")
            raise
        self._f = None
        self._active_name = None
        self._active_size = 0
        self.rotations += 1

    def rotate(self) -> bool:
        """Seal the active segment (if it holds records); True if sealed."""
        if self._f is None or self._active_size == 0:
            return False
        self._seal()
        return True

    def prune(self, upto_epoch: int) -> int:
        """Delete sealed segments fully covered by a checkpoint at
        ``upto_epoch``; returns how many were removed.

        Only *sealed* segments are candidates — the active segment (and
        every epoch after the checkpoint) always survives, so replay from
        the newest manifest is always complete.
        """
        sealed, _ = _segments(self.path)
        removed = 0
        for _, end, name in sealed:
            if end <= upto_epoch:
                os.unlink(os.path.join(self.path, name))
                removed += 1
        if removed:
            self._sync_dir()
            self.pruned += removed
        return removed

    def _sync_dir(self) -> None:
        if not self.fsync:
            return
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- lifecycle -----------------------------------------------------------
    def last_epoch(self) -> int:
        return self._last_epoch

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def stats(self) -> Dict[str, object]:
        sealed, active = _segments(self.path)
        return {"path": self.path, "appended": self.appended,
                "rotations": self.rotations, "pruned": self.pruned,
                "sealed_segments": len(sealed),
                "active_segment": active,
                "active_bytes": self._active_size,
                "last_epoch": self._last_epoch}

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
