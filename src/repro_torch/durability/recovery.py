"""Warm-restart recovery: manifest + checkpoint + WAL-tail replay.

The restart contract of the durable serving stack:

1. :func:`write_manifest` runs after every successful epoch publish.  It
   checkpoints every table (compacted rows + original capacity, one
   atomic-renamed ``.npz``), the *incremental* per-table statistics (so a
   recovered process fingerprints identically to the one that died —
   re-ANALYZE would replace approximations with exact values), the model
   registry as JSON specs, each model's extracted graph fingerprint, and
   (when provided) the extracted graphs themselves — the vertex/edge
   tables a restart adopts straight into its engine's result cache.
2. On restart, :func:`load_manifest` + :func:`restore_database` rebuild
   the database exactly as it stood at the published epoch P;
   :func:`load_graphs` rebuilds the checkpointed extractions.
3. The caller verifies by **bag-digest parity**: every manifest model
   must reproduce its recorded graph fingerprint — recomputed over the
   restored graph tables when a graph checkpoint exists, via a fresh
   extract over the restored database otherwise
   (:class:`RecoveryError` on any mismatch).
4. :func:`replay_wal` then applies the WAL tail (epochs > P) through the
   ordinary mutation API — repopulating the changelog so the engine's
   incremental ``refresh()`` carries the recovered caches forward to the
   live epoch without one cold extract.

No manifest (a durable_dir that never published) degrades to a documented
cold path: the caller's deterministically-reconstructed base database plus
a full WAL replay — valid because :meth:`WriteAheadLog.prune` only ever
discards epochs at or below a written manifest.

The manifest, checkpoint and graph files are the JAX package's format:
either package recovers what the other wrote.  Restored tables land on the
device the caller names (``device=None`` means the CUDA card); replayed
records land where the database's tables already live.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.database import Database, TableStats
from repro_torch.durability.wal import WALRecord, read_all
from repro_torch.incremental.changelog import payload_to_rows
from repro_torch.obs.metrics import failure_counter
from repro_torch.relational import Table
from repro_torch.relational.table import resolve_device

log = logging.getLogger("repro_torch.durability")

MANIFEST_NAME = "MANIFEST.json"
_FORMAT = 1


class RecoveryError(RuntimeError):
    """Recovered state failed verification (or the WAL has an epoch gap)."""


@dataclasses.dataclass
class RecoveryReport:
    """What one restart actually did — surfaced in ``stats()``/``healthz``."""

    path: str                        # "checkpoint" | "cold"
    manifest_epoch: Optional[int]
    live_epoch: int
    replayed_records: int
    skipped_records: int
    truncated_bytes: int
    verified: Dict[str, str]         # model -> graph fingerprint at P

    def summary(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename: the file either exists complete or not at all."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _stats_to_dict(st: TableStats) -> Dict[str, object]:
    return {"rows": st.rows, "width": st.width,
            "distinct": dict(st.distinct),
            "minmax": {c: [int(lo), int(hi)]
                       for c, (lo, hi) in st.minmax.items()}}


def _stats_from_dict(d: Dict[str, object]) -> TableStats:
    return TableStats(rows=int(d["rows"]), width=int(d["width"]),
                      distinct={k: int(v) for k, v in d["distinct"].items()},
                      minmax={c: (int(lo), int(hi))
                              for c, (lo, hi) in d["minmax"].items()})


def write_manifest(dirpath: str, db: Database,
                   model_specs: Dict[str, Dict],
                   graph_digests: Dict[str, str],
                   graphs: Optional[Dict[str, object]] = None
                   ) -> Dict[str, object]:
    """Checkpoint ``db`` at its current epoch and commit the manifest.

    The checkpoint ``.npz`` lands first (atomic rename), the manifest JSON
    second — a crash between the two leaves the *previous* manifest in
    force, pointing at its own still-present checkpoint.  Older checkpoint
    files are garbage-collected only after the new manifest is durable.

    ``graphs`` optionally maps model names to their published
    :class:`~repro_torch.core.extract.ExtractedGraph`\\ s; they land in a
    sibling ``graphs-<epoch>.npz`` so a restart can adopt the extractions
    directly (digest-verified) instead of re-extracting them.
    """
    os.makedirs(dirpath, exist_ok=True)
    epoch = db.epoch
    ckpt_name = f"checkpoint-{epoch:012d}.npz"
    arrays: Dict[str, np.ndarray] = {}
    tables_meta: Dict[str, Dict[str, object]] = {}
    for name, table in db.tables.items():
        data = table.to_numpy()
        for col, arr in data.items():
            arrays[f"{name}/{col}"] = arr
        tables_meta[name] = {
            "capacity": int(table.capacity),
            "columns": list(data),
            "stats": _stats_to_dict(db.stats[name]),
        }
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_write(os.path.join(dirpath, ckpt_name), buf.getvalue())

    graphs_name = None
    graphs_meta: Dict[str, Dict[str, Dict[str, list]]] = {}
    if graphs:
        graphs_name = f"graphs-{epoch:012d}.npz"
        garrays: Dict[str, np.ndarray] = {}
        for mname, graph in graphs.items():
            meta: Dict[str, Dict[str, list]] = {"vertices": {}, "edges": {}}
            for kind, tables in (("vertices", graph.vertices),
                                 ("edges", graph.edges)):
                for label, table in tables.items():
                    data = table.to_numpy()
                    for col, arr in data.items():
                        garrays[f"{mname}/{kind}/{label}/{col}"] = arr
                    meta[kind][label] = list(data)
            graphs_meta[mname] = meta
        gbuf = io.BytesIO()
        np.savez(gbuf, **garrays)
        _atomic_write(os.path.join(dirpath, graphs_name), gbuf.getvalue())

    manifest = {
        "format": _FORMAT,
        "epoch": epoch,
        "checkpoint": ckpt_name,
        "tables": tables_meta,
        "models": model_specs,
        "graph_digests": graph_digests,
    }
    if graphs_name is not None:
        manifest["graphs_file"] = graphs_name
        manifest["graphs"] = graphs_meta
    _atomic_write(os.path.join(dirpath, MANIFEST_NAME),
                  json.dumps(manifest, indent=1, sort_keys=True).encode())
    for fname in os.listdir(dirpath):
        stale_ckpt = (fname.startswith("checkpoint-")
                      and fname.endswith(".npz") and fname != ckpt_name)
        stale_graphs = (fname.startswith("graphs-")
                        and fname.endswith(".npz") and fname != graphs_name)
        if stale_ckpt or stale_graphs:
            os.unlink(os.path.join(dirpath, fname))
    return manifest


def load_manifest(dirpath: str) -> Optional[Dict[str, object]]:
    """The last committed manifest, or ``None`` (→ cold-path recovery)."""
    path = os.path.join(dirpath, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise RecoveryError(
            f"manifest format {manifest.get('format')!r} != {_FORMAT}")
    return manifest


def restore_database(dirpath: str, manifest: Dict[str, object],
                     device=None) -> Database:
    """Rebuild the database exactly as checkpointed at the manifest epoch.

    Capacities and the recorded incremental statistics are restored
    verbatim (never re-analyzed) so every downstream fingerprint — table
    digests, plan-cache keys — matches the process that wrote the
    checkpoint bit for bit.  ``device=None`` means the CUDA card.
    """
    dev = resolve_device(device)
    ckpt = os.path.join(dirpath, manifest["checkpoint"])
    db = Database()
    with np.load(ckpt) as npz:
        for name, meta in manifest["tables"].items():
            cols = {c: npz[f"{name}/{c}"] for c in meta["columns"]}
            db.tables[name] = Table.from_arrays(
                capacity=int(meta["capacity"]), device=dev, **cols)
            db.stats[name] = _stats_from_dict(meta["stats"])
    db.epoch = int(manifest["epoch"])
    return db


def load_graphs(dirpath: str, manifest: Dict[str, object], device=None
                ) -> Dict[str, object]:
    """Rebuild the checkpointed extracted graphs, keyed by model name.

    Returns ``{}`` when the manifest carries no graph checkpoint (older
    manifests, or a publish that had nothing extracted).  Restored tables
    are compacted — valid rows only — which leaves every bag digest, and
    therefore the graph fingerprint, untouched.  ``device=None`` means the
    CUDA card.
    """
    graphs_name = manifest.get("graphs_file")
    if not graphs_name:
        return {}
    from repro_torch.core.extract import ExtractedGraph
    dev = resolve_device(device)
    out: Dict[str, object] = {}
    with np.load(os.path.join(dirpath, graphs_name)) as npz:
        for mname, meta in dict(manifest.get("graphs") or {}).items():
            kinds: Dict[str, Dict[str, Table]] = {}
            for kind in ("vertices", "edges"):
                kinds[kind] = {
                    label: Table.from_arrays(device=dev, **{
                        col: npz[f"{mname}/{kind}/{label}/{col}"]
                        for col in cols})
                    for label, cols in meta[kind].items()}
            out[mname] = ExtractedGraph(vertices=kinds["vertices"],
                                        edges=kinds["edges"])
    return out


def _apply_record(db: Database, rec: WALRecord, device) -> None:
    if rec.kind == "empty":
        db._log(rec.table, None, None, 0, 0)
        return
    if rec.kind == "replace":
        cols = {k.split("/", 1)[1]: v for k, v in rec.payload.items()
                if k.startswith("table/")}
        dev = db.device if db.device is not None else resolve_device(device)
        table = Table.from_arrays(capacity=rec.capacity, device=dev, **cols)
        db.add_table(rec.table, table)
        db.epoch = rec.epoch      # normalize: fresh-name adds don't bump
        return
    if rec.kind == "delta":
        plus = payload_to_rows(rec.payload, "plus")
        minus = payload_to_rows(rec.payload, "minus")
        db.apply_delta(rec.table, plus=plus, minus=minus)
        return
    raise RecoveryError(f"unknown WAL record kind {rec.kind!r}")


def replay_wal(db: Database, dirpath: str, device=None
               ) -> Tuple[int, int, int]:
    """Apply every WAL record past ``db.epoch``; repairs a torn tail.

    Returns ``(replayed, skipped, truncated_bytes)``.  Records at or below
    the database's epoch are skipped (that is what makes recovery
    idempotent — recovering twice replays the same suffix onto the same
    checkpoint); an epoch *gap* means lost history and raises.  Must run
    **before** a WAL is attached for appending, or replay would re-log
    itself.  Replayed rows land on the database's device; ``device`` (None:
    the CUDA card) is used only while the database has no table.
    """
    if db.wal is not None:
        raise RecoveryError("replay_wal on a database with an attached WAL")
    records, truncated = read_all(dirpath, repair=True)
    replayed = skipped = 0
    for rec in records:
        if rec.epoch <= db.epoch:
            skipped += 1
            continue
        if rec.epoch != db.epoch + 1:
            raise RecoveryError(
                f"WAL epoch gap: next record is {rec.epoch}, database is "
                f"at {db.epoch} (pruned past an unpublished epoch?)")
        _apply_record(db, rec, device)
        replayed += 1
    return replayed, skipped, truncated


def recover_database(dirpath: str, base: Database, device=None
                     ) -> Tuple[Database, RecoveryReport]:
    """Full database-side restart: manifest (or cold base) + tail replay.

    ``base`` is only consulted when no manifest exists — the cold path for
    a durable_dir that never published an epoch.  A checkpoint is restored
    onto ``device`` (None: the CUDA card).  Verification of graph
    digests is the *caller's* job (it owns the models and the engine); the
    report carries the digests to check against.
    """
    manifest = load_manifest(dirpath)
    if manifest is None:
        log.warning(
            "durable_dir %s has no manifest: cold extract over the base "
            "database + full WAL replay", dirpath)
        db = base
        path, manifest_epoch = "cold", None
    else:
        db = restore_database(dirpath, manifest, device=device)
        path, manifest_epoch = "checkpoint", int(manifest["epoch"])
        log.info("durable_dir %s: restored checkpoint at epoch %d",
                 dirpath, manifest_epoch)
    replayed, skipped, truncated = replay_wal(db, dirpath, device=device)
    failure_counter("durability_recoveries_total", path=path).inc()
    report = RecoveryReport(
        path=path, manifest_epoch=manifest_epoch, live_epoch=db.epoch,
        replayed_records=replayed, skipped_records=skipped,
        truncated_bytes=truncated, verified={})
    log.info("recovery(%s): %d records replayed, %d skipped, live epoch %d",
             path, replayed, skipped, db.epoch)
    return db, report
