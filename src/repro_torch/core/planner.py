"""Hybrid optimization of join sharing (Section 5.4, Algorithm 2).

The plan state is a set of *units* (single queries or JS-OJ groups) plus a
list of materialized views.  Each iteration enumerates every applicable
single JS-OJ or JS-MV move, costs the resulting plan with Eqs 1-5, keeps the
cheapest, and stops at a fixed point — exactly Algorithm 2's greedy loop.

Scope notes (documented in DESIGN.md): JS-MV moves rewrite single-query
units; a JS-OJ group is built around ONE shared pattern and grows by
absorbing further units that embed that pattern.  Queries rewritten over
views participate in later moves, which is how the paper's Figure 10 hybrid
(MV first, then OJ over the rewritten queries) emerges.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.cost import (
    estimate_query,
    view_cost,
    view_stats_from_estimate,
)
from repro_torch.core.database import Database
from repro_torch.core.jsmv import ViewDef, rewrite_query, view_name
from repro_torch.core.jsoj import MergedQuery, estimate_merged, merge_queries
from repro_torch.core.model import JoinQuery
from repro_torch.core.shared import (
    Embedding,
    enumerate_shared_patterns,
    find_embeddings,
)

MAX_OJ_EMBEDDING_CHOICES = 4  # decomposition choices tried per pair (Alg 1 {D_i})


@dataclasses.dataclass(frozen=True)
class PlanUnit:
    """Either one (possibly view-rewritten) query or one JS-OJ group.

    Groups retain their member (query, embedding) list so a later move can
    re-merge them with an additional member.
    """

    single: Optional[JoinQuery] = None
    group: Optional[MergedQuery] = None
    members: Tuple[Tuple[JoinQuery, Embedding], ...] = ()

    @property
    def is_single(self) -> bool:
        return self.single is not None

    def output_names(self) -> Tuple[str, ...]:
        if self.single is not None:
            return (self.single.name,)
        return self.group.member_names()


def group_unit(pattern, members) -> PlanUnit:
    merged = merge_queries(pattern, list(members))
    return PlanUnit(group=merged, members=tuple(members))


@dataclasses.dataclass(frozen=True)
class ExtractionPlan:
    """Views (materialized in order) + execution units.

    ``reused`` lists views the plan *reads* but does not build: they already
    exist in the database (the engine's cross-request view cache registers
    them before planning), so Eq 5 charges them nothing.
    """

    views: Tuple[ViewDef, ...]
    units: Tuple[PlanUnit, ...]
    reused: Tuple[ViewDef, ...] = ()

    def reads(self) -> Tuple[str, ...]:
        """Base tables and views the plan's views and units read.

        Used by the engine to decide which cached state one table's churn
        can actually affect (eviction and refresh both scope through it).
        """
        names = set()
        for v in tuple(self.reused) + tuple(self.views):
            names |= {r.table for r in v.pattern.relations}
        for u in self.units:
            if u.is_single:
                names |= {r.table for r in u.single.relations}
            else:
                names |= {r.table for r in u.group.pattern.relations}
                for b in u.group.branches:
                    names |= {r.table for r in b.relations}
        return tuple(sorted(names))

    def describe(self) -> str:
        lines = []
        for v in self.reused:
            tables = ",".join(r.table for r in v.pattern.relations)
            lines.append(f"MV {v.name} = [{tables}] (reused, free)")
        for v in self.views:
            tables = ",".join(r.table for r in v.pattern.relations)
            lines.append(f"MV {v.name} = [{tables}] ({v.pattern.num_conds} joins)")
        for u in self.units:
            if u.is_single:
                lines.append(f"QUERY {u.single.name}")
            else:
                lines.append(
                    f"JS-OJ group{list(u.group.member_names())} on "
                    f"[{','.join(r.table for r in u.group.pattern.relations)}]")
        return "\n".join(lines)


def _plan_db(db: Database, views: Sequence[ViewDef]) -> Database:
    """A stats-only shadow database where views carry *estimated* stats.

    Views already registered in ``db`` (the engine's cached views) keep
    their stored stats; only missing ones get a fresh estimate.
    """
    pdb = Database()
    pdb.stats = dict(db.stats)
    pdb.tables = dict(db.tables)  # names only; cost never touches data
    for v in views:
        if v.name in pdb.stats:
            continue
        est = estimate_query(pdb, v.as_query())
        pdb.stats[v.name] = view_stats_from_estimate(est)
    return pdb


def plan_cost(db: Database, plan: ExtractionPlan) -> float:
    """Eq 1 / Eq 3 / Eq 5 assembled over the whole plan.

    Reused views contribute stats but no materialization cost — they
    already exist, which is the engine's whole point.
    """
    pdb = _plan_db(db, tuple(plan.reused) + tuple(plan.views))
    total = 0.0
    for v in plan.views:
        total += view_cost(estimate_query(pdb, v.as_query()))
    for u in plan.units:
        if u.is_single:
            total += estimate_query(pdb, u.single).cost
        else:
            total += estimate_merged(pdb, u.group)[0]
    return total


def _oj_candidates(plan: ExtractionPlan) -> List[ExtractionPlan]:
    """All plans reachable by one JS-OJ merge of two units."""
    out: List[ExtractionPlan] = []
    units = plan.units
    for i, j in itertools.combinations(range(len(units)), 2):
        a, b = units[i], units[j]
        rest = tuple(u for k, u in enumerate(units) if k not in (i, j))
        if a.is_single and b.is_single:
            for pattern, embs in enumerate_shared_patterns([a.single, b.single]):
                ea = embs.get(a.single.name, [])
                eb = embs.get(b.single.name, [])
                if not ea or not eb:
                    continue  # pattern repeated within one query only
                pairs = list(itertools.product(ea, eb))
                for emb_a, emb_b in pairs[:MAX_OJ_EMBEDDING_CHOICES]:
                    out.append(ExtractionPlan(
                        views=plan.views,
                        units=rest + (group_unit(
                            pattern, [(a.single, emb_a), (b.single, emb_b)]),),
                        reused=plan.reused,
                    ))
        elif a.is_single != b.is_single:
            single = a.single if a.is_single else b.single
            grp = b if a.is_single else a
            embs = find_embeddings(grp.group.pattern, single)
            for emb in embs[:MAX_OJ_EMBEDDING_CHOICES]:
                out.append(ExtractionPlan(
                    views=plan.views,
                    units=rest + (group_unit(
                        grp.group.pattern,
                        list(grp.members) + [(single, emb)]),),
                    reused=plan.reused,
                ))
        else:
            # group + group with the identical pattern
            if a.group.pattern.signature == b.group.pattern.signature:
                out.append(ExtractionPlan(
                    views=plan.views,
                    units=rest + (group_unit(
                        a.group.pattern,
                        list(a.members) + list(b.members)),),
                    reused=plan.reused,
                ))
    return out


def _rewrite_units(
    units: Sequence[PlanUnit], view: ViewDef
) -> Tuple[Tuple[PlanUnit, ...], int]:
    """Rewrite every single-query unit over ``view``; returns (units, uses)."""
    new_units: List[PlanUnit] = []
    uses = 0
    for u in units:
        if not u.is_single:
            new_units.append(u)
            continue
        rw, n = rewrite_query(u.single, view)
        uses += n
        new_units.append(PlanUnit(single=rw) if n else u)
    return tuple(new_units), uses


def _mv_candidates(
    plan: ExtractionPlan,
    cached_views: Sequence[ViewDef] = (),
) -> List[ExtractionPlan]:
    """All plans reachable by materializing (or reusing) one shared pattern.

    ``cached_views`` already exist in the database (built by an earlier
    request), so adopting one costs nothing (Eq 5 with Join(V) = 0) — a
    single use suffices, whereas a fresh view must be used twice to ever
    pay for itself.
    """
    out: List[ExtractionPlan] = []
    singles = [u.single for u in plan.units if u.is_single]
    if not singles:
        return out
    existing = ({v.pattern.signature for v in plan.views}
                | {v.pattern.signature for v in plan.reused})
    cached_by_sig = {v.pattern.signature: v for v in cached_views}

    # pre-existing views: free to read, so even one use is a candidate
    for view in cached_views:
        if view.pattern.signature in existing:
            continue
        new_units, uses = _rewrite_units(plan.units, view)
        if uses < 1:
            continue
        out.append(ExtractionPlan(
            views=plan.views, units=new_units,
            reused=plan.reused + (view,)))

    for pattern, _ in enumerate_shared_patterns(singles):
        if pattern.signature in existing:
            continue
        if pattern.signature in cached_by_sig:
            continue  # already proposed above as a free reuse
        if any(r.table.startswith("view_") for r in pattern.relations):
            continue  # no views-of-views (keeps dependency order trivial)
        view = ViewDef(name=view_name(pattern), pattern=pattern)
        new_units, uses = _rewrite_units(plan.units, view)
        if uses < 2:
            continue  # a view used once can never pay for itself
        out.append(ExtractionPlan(
            views=plan.views + (view,), units=new_units,
            reused=plan.reused))
    return out


def optimize(db: Database, queries: Sequence[JoinQuery],
             verbose: bool = False,
             cached_views: Sequence[ViewDef] = ()) -> ExtractionPlan:
    """Algorithm 2: greedy hybrid plan search from the Ringo baseline.

    ``cached_views`` are views that already exist in ``db`` (registered with
    their estimated stats); the search may adopt them as zero-cost JS-MV
    rewrites, which is how cross-request sharing reaches the planner.
    """
    plan = ExtractionPlan(
        views=(), units=tuple(PlanUnit(single=q) for q in queries))
    best_cost = plan_cost(db, plan)
    trace = [("base", best_cost)]
    while True:
        candidates = _oj_candidates(plan) + _mv_candidates(plan, cached_views)
        scored: List[Tuple[float, ExtractionPlan]] = []
        for cand in candidates:
            try:
                scored.append((plan_cost(db, cand), cand))
            except (ValueError, AssertionError, KeyError):
                continue  # un-costable candidate
        if not scored:
            break
        scored.sort(key=lambda t: t[0])
        new_cost, new_plan = scored[0]
        if new_cost < best_cost:
            plan, best_cost = new_plan, new_cost
            trace.append((plan.describe().replace("\n", " | "), new_cost))
        else:
            break
    if verbose:
        for step, c in trace:
            print(f"  cost={c:14.0f}  {step}")
    return plan
