"""Stage 2: join-key inference with compiled containment validation.

Candidate (fk -> pk) pairs are generated from profile signals alone —
the referenced side must look like a key (high uniqueness, few nulls),
the referencing side's value range must fit inside it, and its NDV must
not exceed the key's — then every surviving candidate is *validated
against the data*: a fixed-size sample of the referencing column is
semi-joined against the deduplicated key column, and the hit rate becomes
a calibrated containment score (Wilson lower bound at the observed sample
size, so 500/500 is trusted more than 5/5).

The semi-join runs as a **compiled pipeline**: each check is phrased as
one canonical two-relation :class:`JoinQuery` over tables named
``probe``/``build``, so the :class:`PipelineCompiler`'s ``(kind, unit)``
memo pins one program for *every* check and the process-wide unit store
keys only on the pow-2 capacity buckets — checks against same-sized key
spaces reuse one built unit function, and on the card every check runs
the ``sorted_probe``, ``bloom_build`` and ``bloom_probe`` kernels as
extraction does.  ``compiler=None`` falls back to the eager
:func:`semi_join_mask` reference path.

The sample is numpy's ``default_rng(seed).choice`` over a host copy of the
column's live values, in row order, as in the JAX package: the same rows
are drawn, so ``matched`` agrees check for check.  The probe and build
tables are made on the database's device.

Confidence heuristics, tuned for the name-stripped (honest) setting:

* ``coverage`` — child NDV / parent NDV.  A true FK's draw usually covers
  much of its key space; it also disambiguates between multiple dense
  integer key spaces that all contain the sample.
* surrogate-key penalty — a child column that is itself a perfect key
  (uniqueness ~1) is far more likely a primary/surrogate key than a
  foreign key, which in real data repeats.
* name hints (token overlap between child column and parent column/table)
  only ever *re-rank*; benchmarks strip them (``use_name_hints=False``)
  to show recovery is data-driven.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.database import Database, TableStats
from repro_torch.core.model import ColumnRef, JoinCond, JoinQuery, Relation
from repro_torch.core.pipeline import PipelineCompiler
from repro_torch.discovery.profile import ColumnProfile, TableProfile
from repro_torch.relational import Table
from repro_torch.relational.join import round_capacity, semi_join_mask
from repro_torch.relational.table import NULL_KEY, host

# tokens that name *being* a key, not *which* key ("c_sk" vs "c_id" should
# match on "c", never on "sk"/"id")
GENERIC_TOKENS = frozenset(
    {"id", "sk", "key", "fk", "pk", "ref", "rid", "code", "no", "nbr",
     "num", "col"})

# children this unique are (sur)rogate keys, not foreign keys; 0.97 leaves
# room for KMV estimation error on truly-unique columns
SELF_KEY_UNIQUENESS = 0.97
SELF_KEY_PENALTY = 0.25


def _tokens(text: str) -> frozenset:
    return frozenset(t for t in re.split(r"[\W_]+", text.lower()) if t)


def name_similarity(child_col: str, parent_col: str,
                    parent_table: str) -> float:
    """Fraction of the child column's (non-generic) tokens that appear in
    the parent column or table name."""
    a = _tokens(child_col) - GENERIC_TOKENS
    b = (_tokens(parent_col) | _tokens(parent_table)) - GENERIC_TOKENS
    if not a:
        return 0.0
    return len(a & b) / len(a)


def wilson_lower(successes: int, n: int, z: float = 1.96) -> float:
    """Wilson score lower bound on a binomial proportion.

    The calibration step: a containment of 1.0 measured on 16 samples is
    worth less than one measured on 512, and this is exactly how much.
    """
    if n <= 0:
        return 0.0
    p = successes / n
    denom = 1.0 + z * z / n
    center = p + z * z / (2 * n)
    margin = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return max(0.0, (center - margin) / denom)


@dataclasses.dataclass
class JoinKeyCandidate:
    """One scored (child.col -> parent.col) foreign-key hypothesis."""

    child_table: str
    child_col: str
    parent_table: str
    parent_col: str
    name_score: float = 0.0
    range_fit: float = 0.0        # child value range inside parent range
    coverage: float = 0.0         # child ndv / parent ndv, clamped to 1
    child_uniqueness: float = 0.0
    parent_keyness: float = 0.0
    prior: float = 0.0            # pre-validation score (ranking only)
    containment: float = 0.0      # sampled semi-join hit rate
    wilson_low: float = 0.0       # calibrated containment
    sampled: int = 0
    matched: int = 0
    compiled: bool = False        # True -> validated via compiled pipeline
    confidence: float = 0.0
    accepted: bool = False

    def pair(self) -> Tuple[str, str, str, str]:
        return (self.child_table, self.child_col,
                self.parent_table, self.parent_col)

    def describe(self) -> str:
        return (f"{self.child_table}.{self.child_col} -> "
                f"{self.parent_table}.{self.parent_col} "
                f"(conf={self.confidence:.2f}, "
                f"containment={self.matched}/{self.sampled})")


def generate_candidates(profiles: Dict[str, TableProfile], *,
                        key_threshold: float = 0.9,
                        max_null: float = 0.01,
                        min_range_fit: float = 0.75,
                        ndv_tolerance: float = 1.25,
                        min_prior: float = 0.05,
                        max_parents_per_col: int = 4,
                        use_name_hints: bool = True
                        ) -> List[JoinKeyCandidate]:
    """Profile-driven candidate (fk, pk) pairs, best parents per child col."""
    keys: List[ColumnProfile] = []
    for tp in profiles.values():
        for c in tp.key_columns(key_threshold, max_null):
            keys.append(tp.columns[c])

    out: List[JoinKeyCandidate] = []
    for tp in profiles.values():
        for cc, cp in sorted(tp.columns.items()):
            if not cp.joinable or cp.minmax is None:
                continue
            scored: List[JoinKeyCandidate] = []
            for pp in keys:
                if (pp.table, pp.column) == (tp.name, cc):
                    continue
                if pp.minmax is None or pp.ndv <= 0:
                    continue
                coverage_raw = cp.ndv / pp.ndv
                if coverage_raw > ndv_tolerance:
                    continue
                clo, chi = cp.minmax
                plo, phi = pp.minmax
                span = chi - clo + 1
                overlap = min(chi, phi) - max(clo, plo) + 1
                fit = max(0, overlap) / span
                if fit < min_range_fit:
                    continue
                penalty = (SELF_KEY_PENALTY
                           if cp.uniqueness >= SELF_KEY_UNIQUENESS else 1.0)
                coverage = min(1.0, coverage_raw)
                name = name_similarity(cc, pp.column, pp.table)
                prior = (min(1.0, pp.uniqueness) * min(1.0, fit)
                         * (0.4 + 0.6 * coverage) * penalty)
                if use_name_hints:
                    prior = min(1.0, prior * (0.7 + 0.6 * name))
                if prior < min_prior:
                    continue
                scored.append(JoinKeyCandidate(
                    child_table=tp.name, child_col=cc,
                    parent_table=pp.table, parent_col=pp.column,
                    name_score=name, range_fit=fit, coverage=coverage,
                    child_uniqueness=cp.uniqueness,
                    parent_keyness=min(1.0, pp.uniqueness),
                    prior=prior))
            scored.sort(key=lambda c: (-c.prior, c.parent_table,
                                       c.parent_col))
            out.extend(scored[:max_parents_per_col])
    return out


class ContainmentChecker:
    """Sampled containment checks, each run as one compiled pipeline.

    Every check is the *same* canonical two-relation query over tables
    named ``probe`` (sampled child values, fixed pow-2 capacity) and
    ``build`` (deduplicated parent values, pow-2 capacity) — identical
    query object in, so the compiler's unit memo pins one program and
    built unit functions are shared across all checks whose build sides
    land in the same capacity bucket.  Probe/build tables are cached per
    column, so a child column checked against three parents samples once.
    """

    QUERY = JoinQuery(
        name="containment",
        relations=(Relation("S", "probe"), Relation("R", "build")),
        conds=(JoinCond("S", "k", "R", "v"),),
        src=ColumnRef("S", "k"),
        dst=ColumnRef("R", "v"),
    )

    def __init__(self, db: Database,
                 compiler: Optional[PipelineCompiler] = None,
                 sample: int = 512, seed: int = 0):
        self.db = db
        self.compiler = compiler
        self.sample = int(sample)
        self._rng = np.random.default_rng(seed)
        self._probes: Dict[Tuple[str, str], Tuple[Table, TableStats, int]] = {}
        self._builds: Dict[Tuple[str, str], Tuple[Table, TableStats]] = {}
        self.checks = 0
        self.compiled_checks = 0

    def _column_values(self, table: str, col: str) -> np.ndarray:
        t = self.db.tables[table]
        vals = host(t[col])[host(t.valid)]
        return vals[vals != NULL_KEY]

    def _probe(self, table: str, col: str):
        key = (table, col)
        if key not in self._probes:
            vals = self._column_values(table, col)
            if vals.size > self.sample:
                vals = self._rng.choice(vals, size=self.sample,
                                        replace=False)
            n = int(vals.size)
            probe = Table.from_arrays(
                capacity=round_capacity(self.sample),
                device=self.db.tables[table].device,
                k=vals.astype(np.int32))
            stats = TableStats(
                rows=n, distinct={"k": int(np.unique(vals).size)}, width=1,
                minmax={"k": (int(vals.min()), int(vals.max()))} if n else {})
            self._probes[key] = (probe, stats, n)
        return self._probes[key]

    def _build(self, table: str, col: str):
        key = (table, col)
        if key not in self._builds:
            vals = np.unique(self._column_values(table, col))
            n = int(vals.size)
            build = Table.from_arrays(
                capacity=round_capacity(max(1, n)),
                device=self.db.tables[table].device,
                v=vals.astype(np.int32))
            stats = TableStats(
                rows=n, distinct={"v": n}, width=1,
                minmax={"v": (int(vals.min()), int(vals.max()))} if n else {})
            self._builds[key] = (build, stats)
        return self._builds[key]

    def check(self, cand: JoinKeyCandidate) -> JoinKeyCandidate:
        """Measure containment for one candidate (mutates and returns it)."""
        probe, pstats, n = self._probe(cand.child_table, cand.child_col)
        build, bstats = self._build(cand.parent_table, cand.parent_col)
        cand.sampled = n
        if n == 0 or bstats.rows == 0:
            return cand
        cdb = Database()
        cdb.add_view("probe", probe, pstats)
        cdb.add_view("build", build, bstats)
        self.checks += 1
        if self.compiler is not None:
            out = self.compiler.run_query_edges(cdb, self.QUERY)
            cand.matched = int(out.valid.sum())
            cand.compiled = True
            self.compiled_checks += 1
        else:
            mask = semi_join_mask(probe, build, [("k", "v")])
            cand.matched = int((mask & probe.valid).sum())
        cand.containment = cand.matched / n
        cand.wilson_low = wilson_lower(cand.matched, n)
        return cand


def score_candidate(cand: JoinKeyCandidate,
                    use_name_hints: bool = True) -> float:
    """Final calibrated confidence after containment validation."""
    penalty = (SELF_KEY_PENALTY
               if cand.child_uniqueness >= SELF_KEY_UNIQUENESS else 1.0)
    conf = (cand.wilson_low * cand.parent_keyness
            * (0.4 + 0.6 * cand.coverage) * penalty)
    if use_name_hints:
        conf = min(1.0, conf * (0.7 + 0.6 * cand.name_score))
    return conf


def infer_join_keys(db: Database, profiles: Dict[str, TableProfile], *,
                    compiler: Optional[PipelineCompiler] = None,
                    sample: int = 512, seed: int = 0,
                    key_threshold: float = 0.9,
                    accept_threshold: float = 0.5,
                    use_name_hints: bool = True,
                    max_parents_per_col: int = 4
                    ) -> Tuple[List[JoinKeyCandidate],
                               List[JoinKeyCandidate],
                               ContainmentChecker]:
    """Generate, validate and score FK candidates.

    Returns ``(accepted, all_candidates, checker)``: at most one accepted
    parent per child column (the best-scoring one at or above
    ``accept_threshold``), every validated candidate for inspection, and
    the checker whose counters prove how the checks ran.
    """
    cands = generate_candidates(
        profiles, key_threshold=key_threshold,
        use_name_hints=use_name_hints,
        max_parents_per_col=max_parents_per_col)
    checker = ContainmentChecker(db, compiler=compiler, sample=sample,
                                 seed=seed)
    for c in cands:
        checker.check(c)
        c.confidence = score_candidate(c, use_name_hints=use_name_hints)

    accepted: List[JoinKeyCandidate] = []
    by_child: Dict[Tuple[str, str], List[JoinKeyCandidate]] = {}
    for c in cands:
        by_child.setdefault((c.child_table, c.child_col), []).append(c)
    for group in by_child.values():
        group.sort(key=lambda c: (-c.confidence, -c.name_score,
                                  -c.coverage, c.parent_table, c.parent_col))
        best = group[0]
        if best.confidence >= accept_threshold:
            best.accepted = True
            accepted.append(best)
    accepted.sort(key=lambda c: (-c.confidence,) + c.pair())
    return accepted, cands, checker
