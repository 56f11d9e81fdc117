"""Observability layer: process-wide metrics registry + structured tracer.

Every layer of the package reports into the same two singletons:

* :data:`REGISTRY` — typed, labeled counters/gauges/histograms,
  exportable as a JSON snapshot or Prometheus text format.
* :data:`TRACER` — nested spans with trace/span ids and per-category
  (plan/compile/execute/transfer/csr/queue) time attribution,
  exportable as JSON or Chrome tracing / Perfetto events.

Usage::

    from repro_torch import obs

    with obs.span("engine.extract", model="dblp"):
        with obs.span("plan", category="plan"):
            ...
    obs.REGISTRY.counter("engine_requests_total", path="extract").inc()
"""
from repro_torch.obs.explain import (  # noqa: F401
    PlanReport,
    StepReport,
    UnitReport,
)
from repro_torch.obs.memory import (  # noqa: F401
    array_nbytes,
    csr_nbytes,
    device_memory_stats,
    entry_nbytes,
    graph_nbytes,
    table_nbytes,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    FAILURE_FAMILIES,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    failure_counter,
    get_registry,
)
from repro_torch.obs.trace import (  # noqa: F401
    CATEGORIES,
    TRACER,
    Tracer,
    new_trace_id,
    sanitize_trace_id,
    set_enabled,
    span,
    span_tree_shape,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "FAILURE_FAMILIES", "failure_counter", "get_registry", "CATEGORIES",
    "TRACER", "Tracer", "new_trace_id", "sanitize_trace_id", "set_enabled",
    "span", "span_tree_shape", "traced_call",
    "PlanReport", "UnitReport", "StepReport",
    "array_nbytes", "table_nbytes", "graph_nbytes", "csr_nbytes",
    "entry_nbytes",
    "device_memory_stats",
]


def traced_call(name: str, fn, *args, category: str = "", **attrs):
    """Run ``fn()`` under a fresh root span; return ``(result, breakdown)``.

    The breakdown dict carries wall/plan/compile/execute/transfer/csr/
    queue/other seconds plus attribution coverage.
    """
    with span(name, category=category, **attrs) as s:
        result = fn(*args)
        trace_id = s.trace_id
    return result, TRACER.breakdown(trace_id)
