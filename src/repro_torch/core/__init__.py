# ExtGraph's primary contribution: join-sharing graph extraction
# (JS-OJ + JS-MV + cost-based hybrid planning), Sections 3-5 of the paper.
from repro_torch.core.model import (
    ColumnRef,
    EdgeDef,
    GraphModel,
    JoinCond,
    JoinQuery,
    Predicate,
    Relation,
    VertexDef,
    model_signature,
    pattern_signature,
    query_signature,
)
from repro_torch.core.database import Database, TableStats, from_numpy_tables
from repro_torch.core.extract import ExtractedGraph, Timings, extract_graph
from repro_torch.core.pipeline import PipelineCompiler, clear_executable_cache
from repro_torch.core.planner import ExtractionPlan, PlanUnit, optimize, plan_cost

__all__ = [
    "model_signature",
    "pattern_signature",
    "query_signature",
    "ColumnRef",
    "EdgeDef",
    "GraphModel",
    "JoinCond",
    "JoinQuery",
    "Predicate",
    "Relation",
    "VertexDef",
    "Database",
    "TableStats",
    "ExtractedGraph",
    "Timings",
    "extract_graph",
    "from_numpy_tables",
    "ExtractionPlan",
    "PlanUnit",
    "PipelineCompiler",
    "clear_executable_cache",
    "optimize",
    "plan_cost",
]
