from repro_torch.graph.csr import (
    CSRGraph,
    build_csr,
    csr_offsets,
    triangle_hint_degree,
)
from repro_torch.graph.algorithms import (
    ALGORITHMS,
    degree_stats,
    khop,
    pagerank,
    wcc,
)

__all__ = [
    "CSRGraph",
    "build_csr",
    "csr_offsets",
    "triangle_hint_degree",
    "ALGORITHMS",
    "pagerank",
    "wcc",
    "khop",
    "degree_stats",
]
