"""Run one cell of the benchmark once; print its result as the last line.

    python3 bench/run.py --workload dblp.fresh --seed 7 --seconds 40 --trace 0

From ``BENCHMARK.json`` the cell names a configuration (the tables'
generator and sizes, and the graph model) and a traffic mix.  Set-up
makes the tables from ``--seed``, uploads them into a ``repro_torch``
``Database`` on the card, loads the join kernels (built on a checkout's
first run into ``bench/.cache/kernels``) and warms up; the window then
drives ``ExtractionEngine.extract`` in a closed loop for ``--seconds``.
``--trace 1`` adds a profiled sub-window and one recorded request after
the window and reports the per-layer metrics instead of the end-to-end
ones.  Once the program's state is freed, the reference works the graph
out again from the same arrays and the sampled and last requests'
graphs are compared with it; each number compared is printed beside its
limit.  Exits non-zero without a result when there is no card, or when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / ".cache"
OUT = BENCH_DIR / "out"
JOIN_LIBRARIES = ("sorted_probe", "bloom")

# every build and kernel cache at a fixed path inside the checkout
CACHE_ENV = {"REPRO_COMPILATION_CACHE": CACHE / "kernels",
             "TRITON_CACHE_DIR": CACHE / "triton",
             "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "CUDA_CACHE_PATH": CACHE / "nv"}
for p in (str(ROOT / "src"), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import check, client as clients, guard  # noqa: E402
from harness.spec import Bench  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a metric's reader may read (``metrics/<name>.py``)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    @property
    def done(self):
        return [r for r in self.requests if not r["failed"]]


def _build_db(arrays, device):
    """Upload every table, then ANALYZE each into the program's Database;
    returns (db, upload seconds, analyze seconds)."""
    import torch
    from repro_torch.core.database import Database
    from repro_torch.relational import Table

    t = time.perf_counter()
    tables = {name: Table.from_arrays(device=device, **cols)
              for name, cols in arrays.items()}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    upload = time.perf_counter() - t
    t = time.perf_counter()
    db = Database()
    for name, table in tables.items():
        db.add_table(name, table)
    return db, upload, time.perf_counter() - t


def _expectations(name, expect, records):
    """Lines naming requests whose provenance contradicts what cell
    ``name`` expects (``expect``: a provenance key, and whether it holds
    or, for a list of views, is non-empty)."""
    out = []
    for key, want in expect.items():
        bad = sum(bool(r[key]) != want for r in records)
        if bad:
            out.append(f"cell {name!r}: {bad} of {len(records)} requests "
                       f"had {key} != {want}")
    return out


def _check_rows(config, arrays):
    """The generated row counts must be the configuration's ``rows``."""
    got = {t: len(next(iter(c.values()))) for t, c in arrays.items()}
    if got != config["rows"]:
        raise ValueError(f"configuration {config['name']!r}: generated "
                         f"rows {got} are not its rows {config['rows']}")
    return got


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> dict:
    """One run of cell ``name``; the result object (printed by ``main``)."""
    import numpy as np
    import torch
    from repro_torch.api import model_from_spec
    from repro_torch.kernels import ops as kops

    from harness import devtrace, roofline
    from reference import joins

    cell = bench.workload(name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"
    setup = {"imports_s": time.perf_counter() - T0}

    t = time.perf_counter()
    arrays = bench.generator(config["generator"]).generate(
        config["params"], seed)
    rows = _check_rows(config, arrays)
    setup["generate_s"] = time.perf_counter() - t
    db, setup["upload_s"], setup["analyze_s"] = _build_db(arrays, device)

    t = time.perf_counter()
    if cuda:
        from repro_torch.core.pipeline import (
            enable_persistent_compilation_cache,
        )
        from repro_torch.kernels import _build

        enable_persistent_compilation_cache(
            str(CACHE_ENV["REPRO_COMPILATION_CACHE"]))
        _build.build_all(JOIN_LIBRARIES)
    setup["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    model = model_from_spec(config["model"])
    client = clients.Client(db, model, config["model"], traffic)
    for _ in range(int(traffic["warmup_requests"])):
        rec = client.request()
        if rec["failed"]:
            raise RuntimeError(f"warm-up request failed: {rec['error']}")
    setup["warmup_s"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    log("setup " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f"; setup_s {setup_s:.3f}")

    sample = int(np.random.default_rng([seed, 1]).integers(
        0, int(traffic["sample_first"])))
    gc0 = gc.get_stats()[2]["collections"]
    records, kept, copy_s, window_s = clients.window(client, seconds, sample)
    gc2 = gc.get_stats()[2]["collections"] - gc0
    window_peak = torch.cuda.max_memory_allocated() if cuda else None
    done = [r for r in records if not r["failed"]]
    if not done:
        raise RuntimeError("no request completed in the window: "
                           + records[0].get("error", "none started"))
    lat = [r["latency_s"] for r in done]
    slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:5]
    log(f"window {window_s:.3f} s: {len(records)} requests, "
        f"{len(records) - len(done)} failed; latency median "
        f"{statistics.median(lat) * 1e3:.3f} ms; slowest "
        + ", ".join(f"#{i} {lat[i] * 1e3:.1f}" for i in slow)
        + f" ms; sample #{sample} copied in {copy_s:.3f} s; between "
        f"requests {window_s - sum(r.get('latency_s', 0) for r in records):.3f}"
        f" s; full collections {gc2}; edges a request "
        f"{done[-1]['edges_by_label']}")
    expect = bench.expectations(name, traffic)
    for line in _expectations(name, expect, done):
        log(line)

    profile = least = None
    if trace:
        k = int(traffic["profile_requests"])
        profile = devtrace.capture(
            lambda: [client.request(keep_spans=True).get("spans", [])
                     for _ in range(k)])
        with roofline.recording(kops) as calls:
            client.request()
        least = roofline.least_by_wrapper(calls)
        if profile is not None:
            profile.write_chrome(OUT / f"{name}.{seed}.trace.json")

    ctx = Context(requests=records, window_s=window_s, setup_s=setup_s,
                  peak_bytes=window_peak, profile=profile, least=least,
                  config=config, rows=rows)
    metrics = {}
    for m in bench.metrics(name, trace):
        value = bench.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check: free the program's state first, then the reference; a
    # last request that failed leaves nothing, which the check counts
    graph = client.last_graph
    last = ({}, {}) if graph is None else (
        check.program_edges(graph, client.labels),
        check.program_vertices(graph, config["model"]))
    del graph
    client.close()
    del db, client
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = joins.extract(arrays, config["model"], device)
    off = [check.compare((check.packed(last[0], device), last[1]), want)]
    if kept is not None:
        off.append(check.compare(
            (check.packed(kept[0], device),
             {k: v.to(device) for k, v in kept[1].items()}), want))
    counts = {k: int(v.shape[0]) for k, v in want[0].items()}
    correct, checks = check.verdict({
        "edge_rows_off": sum(e for e, _ in off),
        "vertex_rows_off": sum(v for _, v in off),
        "edge_count_off": sum(abs(r["edges_by_label"][k] - n)
                              for r in done for k, n in counts.items()),
        "requests_failed": len(records) - len(done),
    })
    if kept is None:
        log(f"the sampled request {sample} did not complete: only the "
            "last was compared")
    log(f"checked requests {sample} and {len(records) - 1} of "
        f"{len(records)} in full, and every request's edge counts")
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0}
    result = {"correct": correct, "attempted": len(records),
              "failed": len(records) - len(done), "metrics": metrics,
              "device": dev}
    if trace and profile is not None:
        dev["busy_s"], dev["window_s"] = profile.busy_s, profile.window_s
        result["breakdown"] = profile.breakdown()
    result["checks"] = checks
    return result


def main(argv=None, device: str = "cuda", bench_file=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench.load(bench_file)
    cell = bench.workload(args.workload)

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    os.environ.update({k: str(v) for k, v in CACHE_ENV.items()})
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device)
    loaded = guard.forbidden(sys.modules)
    if loaded:
        log(f"forbidden modules were loaded: {loaded}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
