# Incremental maintenance: CDC change capture, differential propagation of
# extraction queries / JS-MV views, and delta application to cached tables.
# The engine-facing entry point is repro_torch.api.ExtractionEngine.refresh().
from repro_torch.incremental.changelog import (
    ChangeLog,
    MergedDelta,
    TableDelta,
    merge_deltas,
)
from repro_torch.incremental.delta import (
    DeltaExecutor,
    DeltaPlanner,
    DeltaTerm,
    apply_table_delta,
    query_delta_terms,
)

__all__ = [
    "ChangeLog",
    "TableDelta",
    "MergedDelta",
    "merge_deltas",
    "DeltaPlanner",
    "DeltaExecutor",
    "DeltaTerm",
    "query_delta_terms",
    "apply_table_delta",
]
