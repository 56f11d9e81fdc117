"""The import guard: the JAX package and JAX itself stay out of a run."""
from __future__ import annotations

from typing import Iterable, List

# compared by whole top-level names: ``repro_torch`` is not ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden(modules: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
