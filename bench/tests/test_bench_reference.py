"""The benchmark's reference and control against the port, on the CPU.

At sizes a test holds: the dblp generator draws what the port's own
draws, the TPC-DS one draws the specification's rows in tickets, the
plain reference equals ``ExtractionEngine.extract`` edge for edge and
vertex for vertex, the control (set semantics) fails the check, and
nothing under ``bench/reference`` imports the program or JAX.
"""
from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import check  # noqa: E402
from harness.spec import Bench  # noqa: E402
from reference import control, joins  # noqa: E402

TINY = Bench(json.loads((BENCH / "tests" / "data" / "tiny_benchmark.json")
                        .read_text()))
CONFIGS = ("tiny-tpcds", "tiny-dblp")


def _arrays(name, seed):
    config = TINY.config(name)
    return config, TINY.generator(config["generator"]).generate(
        config["params"], seed)


def _program(config, arrays):
    from repro_torch.api import ExtractionEngine, model_from_spec
    from repro_torch.core.database import Database
    from repro_torch.relational import Table

    db = Database()
    for name, cols in arrays.items():
        db.add_table(name, Table.from_arrays(device="cpu", **cols))
    graph = ExtractionEngine(db).extract(
        model_from_spec(config["model"])).graph
    labels = [e["label"] for e in config["model"]["edges"]]
    return (check.packed(check.program_edges(graph, labels), "cpu"),
            check.program_vertices(graph, config["model"]))


def test_generators_draw_what_the_port_draws():
    from repro_torch.data.dblp import make_dblp

    db = make_dblp(scale=1, seed=5, device="cpu")
    arrays = TINY.generator("dblp").generate({"scale": 1}, 5)
    assert sorted(arrays) == sorted(db.tables)
    for name, cols in arrays.items():
        got = db.tables[name].to_numpy()
        assert sorted(cols) == sorted(got), name
        for col, values in cols.items():
            np.testing.assert_array_equal(values, got[col])


def test_tpcds_generator_draws_tickets_at_the_specification_rows():
    gen = TINY.generator("tpcds")
    params = {"scale_factor": 1, "fraction": 0.01}
    arrays = gen.generate(params, 2**31 + 5)
    rows = gen.row_counts(params)
    assert {t: len(c["rid"]) for t, c in arrays.items()} == rows
    assert gen.row_counts({"scale_factor": 10})["store_sales"] == 28_800_991
    for fact, outlet, _ in gen.CHANNELS.values():
        f = arrays[fact]
        assert all(v.dtype == np.int32 for v in f.values())
        assert f["o_sk"].max() < rows[outlet]
        assert f["c_sk"].max() < rows["customer"]
        assert f["i_sk"].max() < rows["item"]
    # tickets: a run of one customer (drawn from 2**30, so two tickets in
    # a row never share one) of lo..hi consecutive items, the last cut
    lo, hi = gen.CHANNELS["store"][2]
    f = gen._fact(np.random.default_rng(3), 10_000, (lo, hi), 2**30,
                  np.arange(1000, dtype=np.int32), 5, 3)
    new = np.flatnonzero(np.diff(f["c_sk"])) + 1
    sizes = np.diff(np.concatenate([[0], new, [10_000]]))
    assert sizes[:-1].min() >= lo and sizes.max() <= hi
    step = np.diff(f["i_sk"]) % 1000
    assert np.all(step[np.setdiff1d(np.arange(9_999), new - 1)] == 1)
    assert f["o_sk"].max() < 3
    again = gen.generate(params, 2**31 + 5)
    assert all(np.array_equal(again[t][c], arrays[t][c])
               for t in arrays for c in arrays[t])


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_port(name):
    config, arrays = _arrays(name, 2**31 + 17)
    want = joins.extract(arrays, config["model"], "cpu")
    got = _program(config, arrays)
    assert check.compare(got, want) == (0, 0)
    assert all(v.numel() > 0 for v in want[0].values())


@pytest.mark.parametrize("name", CONFIGS)
def test_control_is_not_correct(name):
    config, arrays = _arrays(name, 23)
    want = joins.extract(arrays, config["model"], "cpu")
    got = control.extract(arrays, config["model"], "cpu")
    edge_off, vertex_off = check.compare(got, want)
    assert edge_off > 0 and vertex_off == 0
    correct, _ = check.verdict({"edge_rows_off": edge_off,
                                "vertex_rows_off": vertex_off,
                                "edge_count_off": 0, "requests_failed": 0})
    assert not correct


def test_bag_off_counts_rows_either_side_lacks():
    a = torch.tensor([1, 1, 2, 3], dtype=torch.int64)
    assert check.bag_off(a, a.flip(0)) == 0
    assert check.bag_off(a, torch.tensor([1, 2, 3, 3])) == 2
    assert check.bag_off(a, torch.tensor([1, 2, 3])) == 1
    rows = torch.tensor([[1, 5], [2, 6]])
    assert check.bag_off(rows, rows.flip(0)) == 0
    assert check.bag_off(rows, torch.tensor([[1, 5], [2, 7]])) == 2


def test_reference_imports_no_program_and_no_jax():
    banned = {"jax", "jaxlib", "flax", "repro", "repro_torch", "benchmarks"}
    for path in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, \
                (path.name, names)
