"""Schema-to-graph auto-discovery: from a bare :class:`Database` to ranked,
ready-to-run :class:`GraphModel` builder specs.

ExtGraph assumes users already know *which* graph they intend; GraphGen
("Extracting and Analyzing Hidden Graphs from Relational Databases")
observes that real deployments start from a raw schema with no graph model
at all.  This subsystem closes that gap in three stages:

1. **Profiling** (:mod:`repro_torch.discovery.profile`) — per-column profiles
   (type class, null fraction, approx NDV, min/max, uniqueness) from the
   catalog's :class:`TableStats` plus a batched on-device k-minimum-values
   sketch for key-ness.
2. **Join-key inference** (:mod:`repro_torch.discovery.infer`) — candidate
   (fk, pk) pairs scored from name/type/profile signals, validated by
   sampled containment checks *compiled as tiny pipelines* through the
   :class:`repro_torch.core.pipeline.PipelineCompiler`, yielding calibrated
   (Wilson lower-bound) confidence scores.
3. **Model synthesis** (:mod:`repro_torch.discovery.synthesize`) — walks the
   inferred FK graph to propose vertex tables, direct fact->dim edges, and
   JS-style co-role edges through junction tables, emitted as
   ``model_from_spec``-compatible specs with per-edge confidence and
   :class:`DiscoveryProvenance`.

Entry points: :func:`discover` here (or ``ExtractionEngine.discover()``
for the cached, session-integrated form) and
:func:`repro_torch.discovery.evaluate.anonymize_columns` +
:func:`repro_torch.discovery.evaluate.edge_recovery` for honest evaluation with
FK-name hints stripped.
"""
from repro_torch.discovery.orchestrate import discover
from repro_torch.discovery.profile import (
    ColumnProfile,
    TableProfile,
    profile_database,
    profile_table,
)
from repro_torch.discovery.infer import (
    ContainmentChecker,
    JoinKeyCandidate,
    generate_candidates,
    infer_join_keys,
    wilson_lower,
)
from repro_torch.discovery.synthesize import (
    DiscoveryProvenance,
    DiscoveryResult,
    EdgeCandidate,
    VertexCandidate,
    synthesize,
)
from repro_torch.discovery.evaluate import (
    anonymize_columns,
    canonicalize_pairs,
    column_equivalence,
    edge_recovery,
    fk_pairs,
    model_fk_pairs,
    precision_recall,
    rename_query,
)

__all__ = [
    "discover",
    "ColumnProfile",
    "TableProfile",
    "profile_table",
    "profile_database",
    "JoinKeyCandidate",
    "ContainmentChecker",
    "generate_candidates",
    "infer_join_keys",
    "wilson_lower",
    "DiscoveryProvenance",
    "DiscoveryResult",
    "EdgeCandidate",
    "VertexCandidate",
    "synthesize",
    "anonymize_columns",
    "canonicalize_pairs",
    "column_equivalence",
    "model_fk_pairs",
    "fk_pairs",
    "precision_recall",
    "rename_query",
    "edge_recovery",
]
