"""The reader of ``pipeline.gather_pruned_pct``, on synthetic traces.

Two requests lie in the window; a warm-up request before it and a
profiled one after it carry runs that would change the value if they
were read.  The reader gives the value worked out by hand below, and
nothing where the program has nothing for it to read: no run in the
window, or runs without ``pruned_bytes`` (a program that gathers every
column).
"""
from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from repro_torch import obs  # noqa: E402

NAME = "pipeline.gather_pruned_pct"


def _read(ctx):
    spec = importlib.util.spec_from_file_location(
        "test_metric_gather_pruned_pct", BENCH / "metrics" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _request(tracer, start, end, runs):
    """One ``bench.request`` trace from ``start`` to ``end`` holding a
    ``pipeline.run`` span of 1 ms with each of ``runs``' attributes."""
    tid = obs.new_trace_id()
    t = start + 1e-4
    for attrs in runs:
        tracer.record("pipeline.run", t, t + 1e-3, trace_id=tid,
                      parent_id="p", kind="edges", **attrs)
        t += 1e-3
    tracer.record("bench.request", start - 5e-6, end + 5e-6, trace_id=tid,
                  parent_id="")
    return {"failed": False, "start": start, "end": end}


def _run(pruned=None, slots=100, live=10):
    attrs = {"live_bytes": live, "slot_bytes": slots}
    if pruned is not None:
        attrs["pruned_bytes"] = pruned
    return attrs


def _context(tracer, records):
    return types.SimpleNamespace(tracer=tracer, done=records)


def test_pruned_share_over_the_window():
    tracer = obs.Tracer()
    _request(tracer, 1.0, 1.2, [_run(pruned=9000, slots=1000)])  # warm-up
    records = [
        # a view (nothing pruned) and an edge unit
        _request(tracer, 2.0, 2.1, [_run(pruned=0, slots=300),
                                    _run(pruned=200, slots=100)]),
        # an overflowed attempt carries no bytes; the attempt that fit does
        _request(tracer, 2.1, 2.2, [{}, _run(pruned=600, slots=200)]),
    ]
    _request(tracer, 3.0, 3.2, [_run(pruned=0, slots=5000)])     # profiled
    # (0 + 200 + 600) / (0 + 300 + 200 + 100 + 600 + 200) = 800 / 1400
    assert _read(_context(tracer, records)) == \
        pytest.approx(100.0 * 800 / 1400)


def test_a_window_that_prunes_nothing_reads_zero():
    tracer = obs.Tracer()
    records = [_request(tracer, 2.0, 2.1, [_run(pruned=0, slots=300)])]
    assert _read(_context(tracer, records)) == 0.0


@pytest.mark.parametrize("runs", [
    pytest.param([], id="no-run"),
    pytest.param([{}], id="overflowed-only"),
    pytest.param([_run(), _run(slots=0)], id="without-pruned-bytes"),
    pytest.param([_run(pruned=0, slots=0)], id="no-bytes"),
])
def test_nothing_to_read_gives_nothing(runs):
    tracer = obs.Tracer()
    records = [_request(tracer, 2.0, 2.1, [dict(r) for r in runs])]
    assert _read(_context(tracer, records)) is None
    assert _read(_context(tracer, [])) is None


def test_the_program_tracer_is_read_without_a_tracer_in_the_context():
    with obs.span("bench.request") as root:
        with obs.span("pipeline.run", live_bytes=6, slot_bytes=8,
                      pruned_bytes=24):
            pass
    (span,) = [s for s in obs.TRACER.get(root.trace_id) if not s["parent"]]
    ctx = types.SimpleNamespace(done=[{
        "failed": False, "start": span["start_s"],
        "end": span["start_s"] + span["dur_s"]}])
    assert _read(ctx) == pytest.approx(75.0)
