"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the JSON file its entry names; a traffic mix is
``traffic/<name>.json``; what a cell expects of its requests beyond its
mix is ``cells/<name>.json``, where there is one; a metric's reader is
``metrics/<name>.py``; a configuration's generator is
``generators/<generator>.py``.  A new cell, configuration or metric is
new files and entries, never an edit here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


class Bench:
    """One ``BENCHMARK.json`` document, resolved against ``root``."""

    def __init__(self, doc: Mapping, root: Path = ROOT):
        self.doc, self.root = doc, Path(root)

    @classmethod
    def load(cls, path: Optional[Path] = None) -> "Bench":
        path = Path(path) if path else ROOT / "BENCHMARK.json"
        return cls(json.loads(path.read_text()), ROOT)

    def workload(self, name: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> Dict:
        """The mix; one client in a closed loop is the only load the
        client drives, so a mix that asks for another is refused."""
        mix = json.loads((BENCH_DIR / "traffic" / f"{name}.json")
                         .read_text())
        if mix.get("loop") != "closed" or mix.get("clients") != 1:
            raise ValueError(f"traffic {name!r}: only a closed loop with "
                             "one client is driven")
        return mix

    @staticmethod
    def expectations(workload: str, traffic: Mapping) -> Dict:
        """What each request of the cell should show: the mix's
        ``expect``, then the cell's own (``cells/<workload>.json``)."""
        want = dict(traffic.get("expect", {}))
        path = BENCH_DIR / "cells" / f"{workload}.json"
        if path.is_file():
            want.update(json.loads(path.read_text()).get("expect", {}))
        return want

    def metrics(self, workload: str, trace: bool) -> List[Dict]:
        """The cell's metrics: end-to-end ones untraced, per-layer ones
        traced; a metric without ``workloads`` is every cell's."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    @staticmethod
    def reader(metric: str):
        return _load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                            f"bench_metric_{metric.replace('.', '_')}")

    @staticmethod
    def generator(name: str):
        return _load_module(BENCH_DIR / "generators" / f"{name}.py",
                            f"bench_generator_{name}")
