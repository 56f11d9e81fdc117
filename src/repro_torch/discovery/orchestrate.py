"""The one-call discovery pass: profile -> infer -> synthesize.

:func:`discover` is the engine-independent entry point;
``ExtractionEngine.discover()`` wraps it with per-table profile caching
(keyed by stats fingerprint) and a whole-result LRU.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

from repro_torch.core.database import Database
from repro_torch.core.pipeline import PipelineCompiler
from repro_torch.discovery.infer import infer_join_keys
from repro_torch.discovery.profile import SKETCH_K, TableProfile, profile_table
from repro_torch.discovery.synthesize import DiscoveryResult, synthesize


def discover(db: Database,
             tables: Optional[Iterable[str]] = None, *,
             compiler: Optional[PipelineCompiler] = None,
             sample: int = 512,
             sketch_k: int = SKETCH_K,
             key_threshold: float = 0.9,
             accept_threshold: float = 0.5,
             use_name_hints: bool = True,
             max_joins: int = 5,
             seed: int = 0,
             profile_fn: Optional[Callable[[str], TableProfile]] = None
             ) -> DiscoveryResult:
    """Profile ``db`` and emit ranked GraphModel candidates.

    ``compiler`` routes every containment check through one compiled
    pipeline per capacity bucket (``None`` = eager reference path);
    ``profile_fn`` lets a caller (the engine) serve per-table profiles
    from a cache instead of re-sketching.
    """
    names = sorted(db.tables) if tables is None else sorted(set(tables))
    pipe0 = compiler.cache_info() if compiler is not None else {}

    t0 = time.perf_counter()
    if profile_fn is None:
        profiles = {n: profile_table(n, db.tables[n], db.stats[n],
                                     k=sketch_k) for n in names}
    else:
        profiles = {n: profile_fn(n) for n in names}
    profile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    fks, candidates, checker = infer_join_keys(
        db, profiles, compiler=compiler, sample=sample, seed=seed,
        key_threshold=key_threshold, accept_threshold=accept_threshold,
        use_name_hints=use_name_hints)
    infer_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    vertices, edges = synthesize(fks, profiles, max_joins=max_joins)
    synth_s = time.perf_counter() - t0

    stats: Dict[str, object] = {
        "tables": len(names),
        "candidates": len(candidates),
        "accepted_fks": len(fks),
        "edge_candidates": len(edges),
        "containment_checks": checker.checks,
        "compiled_checks": checker.compiled_checks,
        "all_compiled": (checker.checks > 0
                         and checker.compiled_checks == checker.checks),
    }
    if compiler is not None:
        pipe1 = compiler.cache_info()
        stats["pipeline_runs"] = (
            int(pipe1["hits"] + pipe1["misses"])
            - int(pipe0.get("hits", 0) + pipe0.get("misses", 0)))
        stats["executable_misses"] = (
            int(pipe1["misses"]) - int(pipe0.get("misses", 0)))

    return DiscoveryResult(
        profiles=profiles, candidates=candidates, fks=fks,
        vertices=vertices, edges=edges,
        timings={"profile_s": profile_s, "infer_s": infer_s,
                 "synthesize_s": synth_s,
                 "total_s": profile_s + infer_s + synth_s},
        stats=stats,
        params={"tables": tuple(names), "sample": sample,
                "sketch_k": sketch_k, "key_threshold": key_threshold,
                "accept_threshold": accept_threshold,
                "use_name_hints": use_name_hints, "max_joins": max_joins,
                "seed": seed})
