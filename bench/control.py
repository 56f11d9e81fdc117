"""Readings of the control: the reference with bag semantics broken.

    python3 bench/control.py --config dblp --seeds 11,12,13

For each seed, makes the configuration's tables, works out the graph with
the reference and with the control (``reference/control.py``: one row of
each distinct edge), and prints the numbers ``bench/run.py`` compares,
with the control in the program's place, one JSON line a seed.  The
benchmark's own runs never run it; it shows that the check fails the
control, at the cell's own size.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from harness import check  # noqa: E402
from harness.spec import Bench  # noqa: E402
from reference import control, joins  # noqa: E402


def readings(bench: Bench, config_name: str, seed: int, device: str):
    config = bench.config(config_name)
    arrays = bench.generator(config["generator"]).generate(
        config["params"], seed)
    want = joins.extract(arrays, config["model"], device)
    got = control.extract(arrays, config["model"], device)
    edge_off, vertex_off = check.compare(got, want)
    counts = sum(abs(int(got[0][k].shape[0]) - int(v.shape[0]))
                 for k, v in want[0].items())
    return {"edge_rows_off": edge_off, "vertex_rows_off": vertex_off,
            "edge_count_off": counts,
            "edges": {k: int(v.shape[0]) for k, v in want[0].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = Bench.load()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(bench, args.config, seed, args.device)
        correct, checks = check.verdict({**out, "requests_failed": 0})
        print(json.dumps({"config": args.config, "seed": seed,
                          "correct": correct, "checks": checks,
                          "edges": out["edges"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
