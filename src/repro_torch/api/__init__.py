# Public extraction API: a session-based engine that carries the paper's
# join sharing (JS-OJ / JS-MV) across requests, plus fluent/spec model
# construction.
from repro_torch.api.builder import (
    GraphModelBuilder,
    join_query,
    model_from_json,
    model_from_spec,
    model_to_spec,
)
from repro_torch.api.engine import (
    AnalyticsProvenance,
    AnalyticsResult,
    AnalyticsTimings,
    ExtractionEngine,
    ExtractionResult,
    PlanProvenance,
)

__all__ = [
    "ExtractionEngine",
    "ExtractionResult",
    "PlanProvenance",
    "AnalyticsProvenance",
    "AnalyticsResult",
    "AnalyticsTimings",
    "GraphModelBuilder",
    "join_query",
    "model_from_spec",
    "model_from_json",
    "model_to_spec",
]
