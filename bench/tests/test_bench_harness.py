"""The benchmark's harness driven on the CPU at a tiny size.

``bench/run.py``'s command runs a tiny cell in a fresh interpreter and
prints the result line; with the timed path broken underneath
(an edge altered, half of the edges left out, an empty graph, a vertex
altered) the same run reports ``correct`` false; the import guard
compares whole top-level names.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY_FILE = BENCH / "tests" / "data" / "tiny_benchmark.json"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import guard  # noqa: E402
from harness.spec import Bench  # noqa: E402


def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_command_prints_the_result_line():
    code = ("import sys; sys.path.insert(0, 'bench'); import run; "
            "sys.exit(run.main(['--workload', 'tiny-tpcds.fresh', "
            "'--seed', '4294967311', '--seconds', '0.5', '--trace', '0'], "
            f"device='cpu', bench_file={str(TINY_FILE)!r}))")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert {"edges_per_s", "setup_s"} <= set(result["metrics"])
    assert all(set(m) == {"value", "unit"}
               for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def test_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = _run_module()
    assert run.main(["--workload", "tiny-tpcds.fresh", "--seed", "1",
                     "--seconds", "1"], bench_file=TINY_FILE) == 2


def _alter_edge(graph):
    label = next(iter(graph.edges))
    t = graph.edges[label]
    src = t["src"].clone()
    src[0] += 1
    graph.edges[label] = dataclasses.replace(
        t, columns={**t.columns, "src": src})


def _drop_half(graph):
    for label, t in list(graph.edges.items()):
        keep = torch.arange(t.capacity) % 2 == 0
        graph.edges[label] = dataclasses.replace(t, valid=t.valid & keep)


def _empty(graph):
    for label, t in list(graph.edges.items()):
        graph.edges[label] = dataclasses.replace(
            t, valid=torch.zeros_like(t.valid))


def _alter_vertex(graph):
    label = next(iter(graph.vertices))
    t = graph.vertices[label]
    ids = t["id"].clone()
    ids[-1] += 7
    graph.vertices[label] = dataclasses.replace(
        t, columns={**t.columns, "id": ids})


@pytest.mark.parametrize("fault", [_alter_edge, _drop_half, _empty,
                                   _alter_vertex])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    from repro_torch.api.engine import ExtractionEngine

    extract = ExtractionEngine.extract

    def broken(self, model, *args, **kwargs):
        res = extract(self, model, *args, **kwargs)
        fault(res.graph)
        return res

    monkeypatch.setattr(ExtractionEngine, "extract", broken)
    run = _run_module()
    bench = Bench(json.loads(TINY_FILE.read_text()))
    result = run.run_cell(bench, "tiny-tpcds.fresh", 9, 0.1, False, "cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_traffic_expectations_name_contradicting_requests():
    run = _run_module()
    expect = {"plan_cache_hit": True, "views_built": False}
    good = {"plan_cache_hit": True, "views_built": [], "views_reused": ["v"]}
    cold = {"plan_cache_hit": False, "views_built": ["v"],
            "views_reused": []}
    assert run._expectations("c", expect, [good, good]) == []
    lines = run._expectations("c", expect, [cold, good])
    assert len(lines) == 2 and all("1 of 2" in line for line in lines)


def test_a_cell_adds_its_own_expectations_to_its_mix():
    bench = Bench.load()
    fresh = bench.traffic("fresh")
    assert bench.expectations("dblp.fresh", fresh) == {
        "plan_cache_hit": False, "views_reused": False, "views_built": True}
    assert bench.expectations("tpcds-sf10.fraud-fresh", fresh) == \
        fresh["expect"]
    run = _run_module()
    no_view = {"plan_cache_hit": False, "views_built": [],
               "views_reused": []}
    lines = run._expectations(
        "dblp.fresh", bench.expectations("dblp.fresh", fresh), [no_view])
    assert lines == ["cell 'dblp.fresh': 1 of 1 requests had "
                     "views_built != True"]


def test_settings_the_harness_does_not_drive_are_refused(tmp_path,
                                                         monkeypatch):
    from harness import spec

    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "busy.json").write_text(json.dumps(
        {"name": "busy", "loop": "closed", "clients": 4}))
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    with pytest.raises(ValueError, match="one client"):
        Bench({}).traffic("busy")
    run = _run_module()
    arrays = {"t": {"rid": [0, 1, 2]}}
    assert run._check_rows({"name": "c", "rows": {"t": 3}}, arrays) == \
        {"t": 3}
    with pytest.raises(ValueError, match="not its rows"):
        run._check_rows({"name": "c", "rows": {"t": 4}}, arrays)


def test_guard_compares_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "repro", "repro.core.engine", "benchmarks.common",
              "repro_torch", "repro_torch.api", "reprox", "jaxtyping"]
    assert guard.forbidden(loaded) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
         "repro.core.engine", "benchmarks.common"])
