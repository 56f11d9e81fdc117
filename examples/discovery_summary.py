"""Summarise a schema-discovery pass in a form either package can reproduce.

``summary`` reduces a ``DiscoveryResult`` to its counts, its quality on the
anonymized dataset (FK precision and recall, hand-written edge recall) and
three sha1 digests: of the anonymized tables' contents, of the sorted
accepted ``(pair, matched, sampled)`` with every profile's NDV, and of
every validated candidate's ``(pair, sampled, matched, confidence)``.  The
same function reads the JAX package's result and the PyTorch port's, so
their summaries compare as equal dicts.  ``chip_smoke.py`` holds the
port's phase 10 against the constants this script prints for the JAX
package:

    PYTHONPATH=src JAX_PLATFORMS=cpu python examples/discovery_summary.py

``--package repro_torch`` runs the port (``--device cpu`` on the host).
The generators draw their keys from numpy's ``Generator``, whose Zipf
draws differ between numpy releases, so two machines may generate other
TPC-DS tables: ``--save-tables FILE`` keeps the generated tables (valid
rows) in a compressed ``.npz``, and ``--load-tables FILE`` discovers on
those tables instead of generating them, with either package.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import time

import numpy as np

# (dataset, size) of chip_smoke.py's phase 10: TPC-DS SF1's fact size and
# DBLP scale 100
SIZES = (("tpcds", 1000), ("dblp", 100))


def hand_models(pkg: str, dataset: str):
    """(truth models, hand-written edge queries) of ``dataset``, as
    ``tests/test_discovery.py`` scores it."""
    data = importlib.import_module(f"{pkg}.data")
    if dataset in ("dblp", "imdb"):
        m = getattr(data, f"{dataset}_model")()
        return [m], m.queries()
    tpcds = importlib.import_module(f"{pkg}.data.tpcds")
    return ([data.recommendation_model(ch) for ch in tpcds.CHANNELS]
            + [data.fraud_model(ch) for ch in tpcds.CHANNELS],
            data.combined_model().queries())


def make_dataset(pkg: str, dataset: str, size: int, device=None,
                 tables=None):
    """(database, truth models, hand-written edge queries) of ``pkg``'s
    synthetic ``dataset`` at ``size``; ``tables`` ({name: {column:
    array}}) replaces the generated tables."""
    kw = {} if pkg == "repro" else {"device": device}
    if tables is not None:
        core = importlib.import_module(f"{pkg}.core.database")
        rel = importlib.import_module(f"{pkg}.relational")
        db = core.Database({n: rel.Table.from_arrays(**kw, **cols)
                            for n, cols in sorted(tables.items())})
    else:
        data = importlib.import_module(f"{pkg}.data")
        make = {"dblp": lambda: data.make_dblp(scale=size, **kw),
                "imdb": lambda: data.make_imdb(scale=size, **kw),
                "tpcds": lambda: data.make_tpcds(sf=size, **kw)}[dataset]
        db = make()
    return (db, *hand_models(pkg, dataset))


def summary(pkg: str, res, adb, mapping, truth, hand_queries) -> dict:
    """Counts, quality and digests of discovery result ``res`` over the
    anonymized database ``adb`` (``mapping`` from ``anonymize_columns``)."""
    ev = importlib.import_module(f"{pkg}.discovery.evaluate")
    equiv = ev.column_equivalence(adb)
    pred = ev.canonicalize_pairs(ev.fk_pairs(res.fks), equiv)
    want = ev.canonicalize_pairs(ev.model_fk_pairs(truth, mapping), equiv)
    precision, recall = ev.precision_recall(pred, want)
    edges = ev.edge_recovery(hand_queries, res.edges, mapping, equiv=equiv)
    ops = importlib.import_module(f"{pkg}.relational.ops")
    data = sorted((n, ops.table_digest(t)) for n, t in adb.tables.items())
    fks = sorted((c.pair(), c.matched, c.sampled) for c in res.fks)
    ndv = sorted((t, c, p.ndv) for t, tp in res.profiles.items()
                 for c, p in tp.columns.items())
    cands = sorted((c.pair(), c.sampled, c.matched, repr(c.confidence))
                   for c in res.candidates)
    return {
        "candidates": res.stats["candidates"],
        "containment_checks": res.stats["containment_checks"],
        "compiled_checks": res.stats["compiled_checks"],
        "accepted_fks": res.stats["accepted_fks"],
        "edge_candidates": res.stats["edge_candidates"],
        "precision": precision, "recall": recall,
        "edge_recall": edges["recall"],
        "data_sha1": hashlib.sha1(repr(data).encode()).hexdigest(),
        "fk_ndv_sha1": hashlib.sha1(repr((fks, ndv)).encode()).hexdigest(),
        "candidates_sha1": hashlib.sha1(repr(cands).encode()).hexdigest(),
    }


def save_tables(path: str, dbs) -> None:
    """Keep {dataset: database}'s tables (valid rows) in one ``.npz``."""
    np.savez_compressed(path, **{
        f"{dataset}/{name}/{col}": arr
        for dataset, db in dbs.items()
        for name, t in db.tables.items()
        for col, arr in t.to_numpy().items()})


def load_tables(path: str) -> dict:
    """{dataset: {table: {column: array}}} of a :func:`save_tables` file."""
    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            dataset, name, col = key.split("/")
            out.setdefault(dataset, {}).setdefault(name, {})[col] = f[key]
    return out


def run(pkg: str, dataset: str, size: int, device=None, tables=None,
        keep=None) -> dict:
    """Discover on ``pkg``'s anonymized ``dataset`` with the compiled
    pipeline and no name hints; the summary plus its seconds.  ``tables``
    replaces the generated tables; ``keep`` (a dict) receives the
    database."""
    disc = importlib.import_module(f"{pkg}.discovery")
    pipeline = importlib.import_module(f"{pkg}.core.pipeline")
    db, truth, hand = make_dataset(pkg, dataset, size, device, tables)
    if keep is not None:
        keep[dataset] = db
    adb, mapping = disc.anonymize_columns(db)
    kw = {} if pkg == "repro" else {"device": adb.device}
    t0 = time.perf_counter()
    res = disc.discover(adb, compiler=pipeline.PipelineCompiler(**kw),
                        use_name_hints=False)
    seconds = time.perf_counter() - t0
    out = summary(pkg, res, adb, mapping, truth, hand)
    out.update(executable_misses=res.stats.get("executable_misses"),
               discover_s=seconds)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", default="repro",
                        choices=("repro", "repro_torch"))
    parser.add_argument("--device", default=None,
                        help="the port's device (default: the CUDA card)")
    parser.add_argument("--datasets", nargs="+", default=[d for d, _ in SIZES],
                        choices=[d for d, _ in SIZES])
    parser.add_argument("--save-tables", default=None, metavar="FILE")
    parser.add_argument("--load-tables", default=None, metavar="FILE")
    args = parser.parse_args(argv)
    loaded = load_tables(args.load_tables) if args.load_tables else {}
    kept: dict = {}
    for dataset, size in SIZES:
        if dataset not in args.datasets:
            continue
        out = run(args.package, dataset, size, args.device,
                  loaded.get(dataset), kept)
        print(json.dumps({"dataset": dataset, "size": size,
                          "tables_from": args.load_tables if dataset in loaded
                          else f"numpy {np.__version__}", **out}),
              flush=True)
    if args.save_tables:
        save_tables(args.save_tables, kept)


if __name__ == "__main__":
    main()
