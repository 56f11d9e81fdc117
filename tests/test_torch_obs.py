"""The port's tracer: device-timed spans and the join-step accounting.

On the CPU, a fake event factory patched into ``repro_torch.obs.trace``
stands in for CUDA events: an event completes only when the host syncs
(a tensor's ``cpu()``, or the engine's ``synchronize_tables``), so a
span that carries ``device_s`` was resolved after the pipeline's own
sync, and any wait or extra sync is recorded as a violation.  Without
the fake, a CPU extraction records no event.  The new detail spans leave
the eager and compiled structural span trees equal; a unit's
``pipeline.run`` holds one ``pipeline.join`` span a join step, and the
bytes its steps gather over their static slots and over their live rows.
The test marked ``cuda`` runs the same request on a card.

This file imports neither ``jax`` nor ``repro``.
"""
import collections
import types

import pytest
import torch

from repro_torch import obs
from repro_torch.api import ExtractionEngine
from repro_torch.api import engine as engine_mod
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.pipeline import clear_executable_cache
from repro_torch.obs import trace as trace_mod
import repro_torch.data as tdata

CASES = {
    "dblp": (lambda dev: tdata.make_dblp(scale=1, device=dev),
             tdata.dblp_model, "extgraph"),
    "tpcds": (lambda dev: tdata.make_tpcds(sf=1, device=dev),
              lambda: tdata.recommendation_model("store"), "extgraph"),
}


# The bytes of one output row of each join step, by (unit kind, steps).
# A view ("query") keeps every column of its tables: dblp's author ⋈
# wrote ⋈ paper, tpcds's one-step view.  Every other step gathers only
# what a later step or the unit's output reads: an edge unit's steps two
# int32 columns; tpcds's merged unit two in its shared chain, then five
# in its outer attachment (the shared chain's two and its row id, the
# branch's output column and row id).
STEP_WIDTHS = {
    "dblp": {("query", 2): (24, 36), ("edges", 2): (8, 8),
             ("edges", 3): (8, 8, 8)},
    "tpcds": {("query", 1): (32,), ("edges", 2): (8, 8),
              ("merged", 2): (8, 20)},
}


@pytest.fixture(scope="module")
def cpu_dbs():
    return {name: make("cpu") for name, (make, _, _) in CASES.items()}


@pytest.fixture(autouse=True)
def _tracer_on():
    obs.set_enabled(True)
    yield
    obs.set_enabled(True)


def _extract(db, case, **engine_kw):
    _, model, method = CASES[case]
    with obs.span("test.request") as root:
        res = ExtractionEngine(db, **engine_kw).extract(model(),
                                                        method=method)
    return res, obs.TRACER.get(root.trace_id)


def _children(spans):
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s["parent"], []).append(s)
    return by_parent


class _FakeDevice:
    """A device whose events complete at the host's next sync."""

    def __init__(self):
        self.recorded = 0          # events recorded so far
        self.completed = 0         # events a sync has completed
        self.violations = []

    def sync(self):
        self.completed = self.recorded


class _FakeEvent:
    def __init__(self, device):
        self.device = device
        self.seq = None

    def record(self, stream=None):
        self.device.recorded += 1
        self.seq = self.device.recorded

    def query(self):
        return self.seq is not None and self.seq <= self.device.completed

    def elapsed_time(self, end):
        if not (self.query() and end.query()):
            self.device.violations.append("elapsed_time before completion")
        return 0.25 * (end.seq - self.seq)            # ms

    def synchronize(self):
        self.device.violations.append("Event.synchronize")

    def wait(self, stream=None):
        self.device.violations.append("Event.wait")


@pytest.fixture
def fake_device(monkeypatch):
    """Fake events in ``obs``; the port's two syncs complete them."""
    device = _FakeDevice()
    monkeypatch.setattr(trace_mod, "_cuda_ready", lambda: True)
    monkeypatch.setattr(trace_mod, "_current_device", lambda: 0)
    monkeypatch.setattr(trace_mod, "_new_event",
                        lambda dev: _FakeEvent(device))
    monkeypatch.setattr(obs.TRACER, "_events",
                        collections.defaultdict(list))
    cpu = torch.Tensor.cpu

    def syncing_cpu(self, *args, **kwargs):
        device.sync()
        return cpu(self, *args, **kwargs)

    sync_tables = engine_mod.synchronize_tables

    def syncing_tables(tables):
        sync_tables(tables)
        device.sync()

    monkeypatch.setattr(torch.Tensor, "cpu", syncing_cpu)
    monkeypatch.setattr(engine_mod, "synchronize_tables", syncing_tables)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: device.violations.append("synchronize"))
    yield device
    obs.TRACER._pending.clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_spans_resolve_after_the_pipeline_sync(cpu_dbs, fake_device,
                                                      case):
    _, spans = _extract(cpu_dbs[case], case)
    timed = [s for s in spans if "device_s" in s["attrs"]]
    assert timed and fake_device.violations == []
    assert not obs.TRACER._pending
    assert {s["name"] for s in timed} == {"pipeline.join"}
    assert len(timed) == sum(s["name"] == "pipeline.join" for s in spans)
    assert all(s["attrs"]["device_s"] > 0 for s in timed)


def test_a_pair_unfinished_at_resolve_stays_pending_and_is_counted(
        fake_device, monkeypatch):
    tracer = obs.Tracer()
    with tracer.span("a", device=True) as a:
        pass
    assert tracer.resolve_device_spans() == 0          # no sync yet
    assert "device_s" not in a.attrs and len(tracer._pending) == 1
    assert obs.REGISTRY.value("trace_device_spans_total",
                              outcome="incomplete") >= 1
    fake_device.sync()
    assert tracer.resolve_device_spans() == 1
    assert a.attrs["device_s"] == pytest.approx(0.25e-3)
    assert fake_device.violations == []


def test_pending_pairs_are_bounded(fake_device, monkeypatch):
    monkeypatch.setattr(trace_mod, "MAX_PENDING_DEVICE_SPANS", 3)
    tracer = obs.Tracer()
    before = obs.REGISTRY.value("trace_device_spans_total",
                                outcome="dropped")
    for _ in range(5):
        with tracer.span("s", device=True):
            pass
    assert len(tracer._pending) == 3
    assert obs.REGISTRY.value("trace_device_spans_total",
                              outcome="dropped") == before + 2
    fake_device.sync()
    assert tracer.resolve_device_spans() == 3
    # dropped and resolved events go back to the pool: the fifth span
    # reused the first dropped pair, so 8 events served 10 records
    pool = tracer._events[0]
    assert fake_device.recorded == 10
    assert len(pool) == len({id(e) for e in pool}) == 8


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_spans_add_no_host_sync(cpu_dbs, fake_device, monkeypatch,
                                      case):
    """The port's tensor-to-host points a request, counted with device
    spans on and with the tracer off, are the same."""
    counts = {"n": 0}

    def wrap(fn):
        def counted(*args, **kwargs):
            counts["n"] += 1
            return fn(*args, **kwargs)
        return counted

    for name in ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, wrap(getattr(torch.Tensor,
                                                             name)))
    _extract(cpu_dbs[case], case)                       # warm the caches
    counts["n"] = 0
    _extract(cpu_dbs[case], case)
    traced = counts["n"]
    obs.set_enabled(False)
    counts["n"] = 0
    _extract(cpu_dbs[case], case)
    assert traced == counts["n"] > 0
    assert fake_device.violations == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_cpu_extraction_records_no_event(cpu_dbs, monkeypatch, case):
    def no_event(dev):
        raise AssertionError("an event was made on the CPU")

    monkeypatch.setattr(trace_mod, "_new_event", no_event)
    _, spans = _extract(cpu_dbs[case], case)
    assert not obs.TRACER._pending
    assert not any("device_s" in s["attrs"] for s in spans)
    assert any(s["name"] == "pipeline.join" for s in spans)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_and_compiled_share_the_structural_tree(cpu_dbs, case):
    _, compiled = _extract(cpu_dbs[case], case)
    _, eager = _extract(cpu_dbs[case], case, compiled=False)
    assert obs.span_tree_shape(compiled) == obs.span_tree_shape(eager)
    detail = {s["name"] for s in compiled if s["detail"]}
    assert {"pipeline.join", "pipeline.program", "plan.snapshot",
            "plan.evict_views", "plan.key", "plan.optimize",
            "engine.harvest_views", "engine.remember"} <= detail
    assert not any(s["name"] == "pipeline.join" for s in eager)


@pytest.mark.parametrize("case", sorted(CASES))
def test_join_spans_hold_live_rows_and_slots(cpu_dbs, case):
    clear_executable_cache()                # every unit logs its capacities
    _, spans = _extract(cpu_dbs[case], case)
    by_parent = _children(spans)
    units = {s["parent"] for s in spans if s["name"] == "pipeline.run"}
    assert units
    for unit in units:
        kids = by_parent[unit]
        compiles = [s for s in kids
                    if s["name"].startswith("pipeline.compile:")]
        runs = [s for s in kids if s["name"] == "pipeline.run"]
        assert len(compiles) == len(runs)       # a retry builds anew
        for comp, run in zip(compiles, runs):
            caps = comp["attrs"]["capacities"]
            joins = [s for s in by_parent.get(run["id"], [])
                     if s["name"] == "pipeline.join"]
            assert len(joins) == len(caps)      # one span a join step
        caps = compiles[-1]["attrs"]["capacities"]
        a = runs[-1]["attrs"]                   # the attempt that fit
        if caps:
            widths = STEP_WIDTHS[case][(a["kind"], len(caps))]
            assert 0 < a["live_bytes"] <= a["slot_bytes"]
            assert a["slot_bytes"] == sum(c * w for c, w in zip(caps, widths))
        else:
            assert "slot_bytes" not in a
    assert any(s["name"] == "pipeline.program" for s in spans)


def test_a_unit_function_knows_its_step_widths(cpu_dbs):
    """``fn.row_bytes`` is set by the first call, one entry a join step,
    and the run's ``slot_bytes`` is its sum over the capacities."""
    clear_executable_cache()
    _, spans = _extract(cpu_dbs["dblp"], "dblp")
    fns = list(pipeline_mod._EXECUTABLE_CACHE.items())
    assert fns
    slot_bytes = sorted(
        sum(c * w for c, w in zip(key[2], fn.row_bytes)) for key, fn in fns
        if key[2])
    runs = sorted(s["attrs"]["slot_bytes"] for s in spans
                  if s["name"] == "pipeline.run"
                  and "slot_bytes" in s["attrs"])
    assert runs == slot_bytes
    for key, fn in fns:
        assert len(fn.row_bytes) == len(key[2])


@pytest.mark.parametrize("gather,want", [
    pytest.param(None, 4 + 8 + 4 + 1, id="every-column"),
    pytest.param({"a.v", "b.f"}, 8 + 1, id="gather"),
    pytest.param({"b.k", "c.z"}, 4, id="names-of-neither-side"),
])
def test_row_bytes_counts_every_column_of_both_sides(gather, want):
    from repro_torch.relational import Table

    left = Table.from_arrays(device="cpu", **{
        "a.k": torch.zeros(4, dtype=torch.int32),
        "a.v": torch.zeros(4, dtype=torch.int64)})
    right = Table.from_arrays(device="cpu", **{
        "b.k": torch.zeros(2, dtype=torch.int32),
        "b.f": torch.zeros(2, dtype=torch.bool)})
    assert pipeline_mod._row_bytes(left, right, gather) == want


def _kind(key):
    """A unit function's kind, from its store key's program signature."""
    sig = key[0]
    return "merged" if sig[0] == "m" else ("edges" if sig[2] else "query")


def _fitted_runs(spans):
    """(kind, capacities, attributes) of each unit's attempt that fit: its
    last ``pipeline.run`` and the capacities of its last build."""
    by_parent = _children(spans)
    out = []
    for unit in {s["parent"] for s in spans if s["name"] == "pipeline.run"}:
        kids = sorted(by_parent[unit], key=lambda s: s["start_s"])
        comp = [s for s in kids if s["name"].startswith("pipeline.compile:")]
        run = [s for s in kids if s["name"] == "pipeline.run"][-1]
        out.append((run["attrs"]["kind"],
                    tuple(comp[-1]["attrs"]["capacities"]), run["attrs"]))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_pruned_bytes_are_the_capacities_times_the_pruned_widths(
        cpu_dbs, monkeypatch, case):
    """``pruned_bytes`` on a unit's ``pipeline.run`` is Σ capacity × (the
    bytes of a row of every column less those gathered) over its steps
    (``fn.pruned_bytes``), so it and ``slot_bytes`` add up to what the
    steps would gather with every column kept."""
    clear_executable_cache()
    _, spans = _extract(cpu_dbs[case], case)
    pruned = {(_kind(k), k[2]): fn
              for k, fn in pipeline_mod._EXECUTABLE_CACHE.items()}
    monkeypatch.setattr(pipeline_mod, "_gather_sets",
                        lambda program: (None,) * len(program.capacities))
    clear_executable_cache()
    _, full_spans = _extract(cpu_dbs[case], case)
    full = {(_kind(k), k[2]): fn
            for k, fn in pipeline_mod._EXECUTABLE_CACHE.items()}
    clear_executable_cache()
    assert set(pruned) == set(full)
    full_slots = {(kind, caps): a["slot_bytes"]
                  for kind, caps, a in _fitted_runs(full_spans) if caps}
    runs = [r for r in _fitted_runs(spans) if r[1]]
    assert len(runs) == len(full_slots)
    assert any(a["pruned_bytes"] > 0 for _, _, a in runs)
    for kind, caps, a in runs:
        fn, every = pruned[(kind, caps)], full[(kind, caps)].row_bytes
        assert full[(kind, caps)].pruned_bytes == 0
        assert a["pruned_bytes"] == fn.pruned_bytes == sum(
            c * (w - k) for c, w, k in zip(caps, every, fn.row_bytes))
        assert a["pruned_bytes"] + a["slot_bytes"] == \
            sum(c * w for c, w in zip(caps, every)) == \
            full_slots[(kind, caps)]
        if kind == "query":
            assert a["pruned_bytes"] == 0


def test_steps_of_an_overflowed_attempt_are_marked_retry(cpu_dbs):
    """An overflowed attempt is followed by another ``pipeline.run`` of
    its unit and carries no byte accounting: only the attempt that fits
    counts what its steps gathered."""
    from repro_torch.core.pipeline import PipelineCompiler

    clear_executable_cache()
    _, spans = _extract(cpu_dbs["dblp"], "dblp",
                        compiler=PipelineCompiler(initial_capacity_clamp=8))
    by_parent = _children(spans)
    retried = 0
    for unit in {s["parent"] for s in spans if s["name"] == "pipeline.run"}:
        runs = sorted((s for s in by_parent[unit]
                       if s["name"] == "pipeline.run"),
                      key=lambda s: s["start_s"])
        retried += len(runs) - 1
        assert all("slot_bytes" not in s["attrs"] for s in runs[:-1])
        a = runs[-1]["attrs"]
        assert 0 < a["live_bytes"] <= a["slot_bytes"]
    assert retried > 0


def test_spans_sit_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.profiled"):
            torch.ones(4).sum()
    (event,) = [e for e in prof.events() if e.name == "test.profiled"]
    # a host operator: a user annotation would be mirrored onto the device
    assert not event.is_user_annotation


def test_a_torch_without_the_private_profiler_hooks_loses_only_the_ranges(
        monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    enabled, make_range = trace_mod._profiler_hooks(types.SimpleNamespace())
    assert make_range is None and enabled() is False
    monkeypatch.setattr(trace_mod, "_profiler_enabled", enabled)
    monkeypatch.setattr(trace_mod, "_profiler_range", make_range)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.unprofiled") as sp:
            torch.ones(4).sum()
    assert obs.TRACER.get(sp.trace_id)[0]["name"] == "test.unprofiled"
    assert not [e for e in prof.events() if e.name == "test.unprofiled"]


@pytest.mark.cuda
def test_join_device_time_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    db = tdata.make_dblp(scale=1, device="cuda")
    unresolved = [obs.REGISTRY.value("trace_device_spans_total", outcome=o)
                  for o in ("incomplete", "dropped")]
    for _ in range(2):                      # the second request is timed
        res, spans = _extract(db, "dblp")
    joins = [s for s in spans if s["name"] == "pipeline.join"]
    assert joins and all(s["attrs"]["device_s"] > 0 for s in joins)
    assert sum(s["attrs"]["device_s"] for s in joins) <= res.timings.extract_s
    # the health check: every pair was complete at the sync after it
    assert unresolved == [
        obs.REGISTRY.value("trace_device_spans_total", outcome=o)
        for o in ("incomplete", "dropped")]
