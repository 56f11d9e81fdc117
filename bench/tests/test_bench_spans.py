"""The readers of the program's spans, on synthetic traces.

Three requests lie in the window; a warm-up request before it and a
profiled one after it carry spans that would change every value if they
were read.  Each reader gives the value worked out by hand below, and
nothing where the program has nothing for it to read.
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

from harness import spans as window  # noqa: E402
from repro_torch import obs  # noqa: E402


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"test_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _request(tracer, start, end, children):
    """One ``bench.request`` trace: root from ``start`` to ``end``, and
    ``children`` as (name, attrs) spans of 1 ms each inside it."""
    tid = obs.new_trace_id()
    t = start + 1e-4
    for name, attrs in children:
        tracer.record(name, t, t + attrs.pop("dur_s", 1e-3), trace_id=tid,
                      parent_id="p", **attrs)
        t += 1e-3
    tracer.record("bench.request", start - 5e-6, end + 5e-6, trace_id=tid,
                  parent_id="")
    return {"failed": False, "start": start, "end": end}


def _join(device_s=None):
    return ("pipeline.join",
            {} if device_s is None else {"device_s": device_s})


def _run(live_bytes=None, slot_bytes=None):
    attrs = {"kind": "merged"}
    if slot_bytes is not None:
        attrs.update(live_bytes=live_bytes, slot_bytes=slot_bytes)
    return ("pipeline.run", attrs)


def _context(tracer, records):
    return types.SimpleNamespace(tracer=tracer, done=records)


def _outside():
    return [("view:v", {"built": True, "dur_s": 9.0}),
            _run(live_bytes=4000, slot_bytes=4000), _join(device_s=9.0)]


@pytest.fixture
def window_ctx():
    tracer = obs.Tracer()
    _request(tracer, 1.0, 1.2, _outside())                  # warm-up
    records = [
        _request(tracer, 2.0, 2.1, [
            ("view:v1", {"built": True, "dur_s": 0.010}),
            ("view:v2", {"built": True, "dur_s": 0.020}),
            _run(live_bytes=80, slot_bytes=320),
            _join(device_s=0.002), _join(device_s=0.003)]),
        _request(tracer, 2.1, 2.2, [
            ("view:v1", {"built": False, "dur_s": 0.005}),
            _run(live_bytes=480, slot_bytes=640), _join(device_s=0.004)]),
        _request(tracer, 2.2, 2.3, [
            ("view:v3", {"built": True, "dur_s": 0.040}),
            _run(), _join(device_s=0.001), _join()]),
    ]
    _request(tracer, 3.0, 3.2, _outside())                  # profiled
    return _context(tracer, records)


def test_the_window_holds_its_own_requests_only(window_ctx):
    traces = window.window_traces(window_ctx)
    assert len(traces) == 3
    assert all(len(window.named(t, "bench.request")) == 1 for t in traces)


def test_view_build_ms(window_ctx):
    # requests 1 and 3 built views: (10 + 20) ms and 40 ms
    assert _reader("pipeline.view_build_ms")(window_ctx) == \
        pytest.approx(35.0)


def test_join_device_ms(window_ctx):
    # (2 + 3), 4 and 1 ms; the step without a device time adds nothing
    assert _reader("pipeline.join_device_ms")(window_ctx) == \
        pytest.approx(10.0 / 3)


def test_join_live_pct(window_ctx):
    # (80 + 480) / (320 + 640) = 560 / 960; the run without bytes (an
    # overflowed attempt) adds nothing
    assert _reader("pipeline.join_live_pct")(window_ctx) == \
        pytest.approx(100.0 * 560 / 960)


@pytest.mark.parametrize("name", ["pipeline.view_build_ms",
                                  "pipeline.join_device_ms",
                                  "pipeline.join_live_pct"])
def test_nothing_to_read_gives_nothing(name):
    tracer = obs.Tracer()
    records = [_request(tracer, 2.0, 2.1, [
        ("view:v1", {"built": False}), _run(), _join()])]
    assert _reader(name)(_context(tracer, records)) is None
    assert _reader(name)(_context(tracer, [])) is None


def test_the_program_tracer_is_read_without_a_tracer_in_the_context():
    with obs.span("bench.request") as root:
        with obs.span("pipeline.run", live_bytes=6, slot_bytes=8):
            pass
    (span,) = [s for s in obs.TRACER.get(root.trace_id) if not s["parent"]]
    ctx = types.SimpleNamespace(done=[{
        "failed": False, "start": span["start_s"],
        "end": span["start_s"] + span["dur_s"]}])
    assert _reader("pipeline.join_live_pct")(ctx) == pytest.approx(75.0)
