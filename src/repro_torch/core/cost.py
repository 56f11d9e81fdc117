"""Cost model — Eqs 1-5 of the paper, adapted from disk pages to bytes.

PostgreSQL costs joins in buffer-pool page I/O (``A_D * N_P``).  The TPU
analogue of a "page access" is HBM traffic, so every term below is measured
in *bytes moved*, with small multipliers for the sort (build) and probe
phases of our sort-merge join.  The structure of the model is exactly the
paper's:

  Eq 1   Cost(P_base)  = sum_i Join(Q_i)
  Eq 2   Join(Q)       = sum_i Build(T_i) + Probe(T_1)    (left-deep)
  Eq 3   Join(Q_M)     = Join(SQ_S) + sum_i Join(SQ_i) + Outer(O)
  Eq 4   Outer(O)      = sum_i Build(SQ_i) + Probe(SQ_S)
  Eq 5   Cost(P_MV)    = sum_k (Join(V_k) + A_D * N_P(V_k)) + sum_i Join(Q_i')

Cardinalities use the classic System-R estimator: |A >< B| on key k =
|A| * |B| / max(ndv_A(k), ndv_B(k)).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.database import Database, TableStats
from repro_torch.core.model import JoinCond, JoinQuery, Relation, join_schedule

# sort-merge join constants (bytes-moved multipliers)
C_BUILD = 1.5   # sort of the build side (multiple passes over its bytes)
C_PROBE = 1.0   # streaming binary-search probe
C_OUT = 1.0     # writing the join result
A_D = 2.0       # materialized view: write once + read once (Eq 5's A_D*N_P)
# fixed per-join-operator cost (dispatch/compile floor), in byte-units —
# the analogue of PostgreSQL's per-operator startup cost: without it the
# planner applies join sharing to joins too small to ever repay the
# outer-join/materialization machinery (measured 10x regressions on the
# toy-scale fraud workload)
C_FIXED = 4e6
FILTER_SEL = {"==": None, "!=": 0.9, "<": 1 / 3, "<=": 1 / 3,
              ">": 1 / 3, ">=": 1 / 3}


@dataclasses.dataclass
class RelEstimate:
    """Running estimate for a (partial) join result."""

    rows: float
    width: int                      # columns
    ndv: Dict[Tuple[str, str], float]  # (alias, col) -> distinct estimate

    def bytes(self) -> float:
        return self.rows * self.width * 4.0

    def col_ndv(self, alias: str, col: str) -> float:
        return max(1.0, min(self.ndv.get((alias, col), self.rows), self.rows))


def scan_estimate(db: Database, rel: Relation) -> RelEstimate:
    st = db.stats[rel.table]
    rows = float(st.rows)
    sel = 1.0
    for f in rel.filters:
        s = FILTER_SEL[f.op]
        sel *= (1.0 / st.ndv(f.col)) if s is None else s
    rows = max(1.0, rows * sel)
    ndv = {
        (rel.alias, c): min(float(d), rows) for c, d in st.distinct.items()
    }
    return RelEstimate(rows=rows, width=st.width, ndv=ndv)


def _join_card(
    cur: RelEstimate, new: RelEstimate, conds: Sequence[JoinCond],
    new_alias: str,
) -> Tuple[float, Dict]:
    """Estimated rows + updated ndv after joining ``new`` on ``conds``."""
    rows = cur.rows * new.rows
    for c in conds:
        if c.right == new_alias:
            lv = cur.col_ndv(c.left, c.lcol)
            rv = new.col_ndv(c.right, c.rcol)
        else:
            lv = cur.col_ndv(c.right, c.rcol)
            rv = new.col_ndv(c.left, c.lcol)
        rows /= max(lv, rv)
    rows = max(1.0, rows)
    ndv = dict(cur.ndv)
    ndv.update(new.ndv)
    ndv = {k: min(v, rows) for k, v in ndv.items()}
    return rows, ndv


@dataclasses.dataclass
class QueryEstimate:
    rows: float
    width: int
    cost: float
    order: Tuple[str, ...]
    ndv: Dict[Tuple[str, str], float]

    def to_rel(self) -> RelEstimate:
        return RelEstimate(rows=self.rows, width=self.width, ndv=self.ndv)


def estimate_query(
    db: Database,
    query: JoinQuery,
    order: Optional[Sequence[str]] = None,
) -> QueryEstimate:
    """Left-deep cost (Eq 2) with the best connected join order.

    The paper assumes the base system finds the optimal order; join graphs
    are tiny, so we brute-force connected left-deep orders.
    """
    aliases = list(query.aliases())
    if len(aliases) == 1:
        est = scan_estimate(db, query.relations[0])
        return QueryEstimate(est.rows, est.width, C_PROBE * est.bytes(),
                             tuple(aliases), est.ndv)

    scans = {r.alias: scan_estimate(db, r) for r in query.relations}

    def run(seq: Sequence[str]) -> Optional[QueryEstimate]:
        try:
            schedule = join_schedule(query, seq)
        except ValueError:
            return None  # disconnected order: skip (no cartesian plans)
        cur = scans[seq[0]]
        cur = RelEstimate(cur.rows, cur.width, dict(cur.ndv))
        cost = 0.0
        for a, conds, closing in schedule:
            new = scans[a]
            rows, ndv = _join_card(cur, new, conds, a)
            cost += C_BUILD * new.bytes() + C_PROBE * cur.bytes() + C_FIXED
            width = cur.width + new.width
            cur = RelEstimate(rows, width, ndv)
            cost += C_OUT * cur.bytes()
            # cycle-closing conditions among already-joined aliases
            for c in closing:
                lv = cur.col_ndv(c.left, c.lcol)
                rv = cur.col_ndv(c.right, c.rcol)
                cur.rows = max(1.0, cur.rows / max(lv, rv))
        return QueryEstimate(cur.rows, cur.width, cost, tuple(seq), cur.ndv)

    if order is not None:
        est = run(order)
        if est is None:
            raise ValueError(f"order {order} is not connected for {query.name}")
        return est

    best: Optional[QueryEstimate] = None
    n = len(aliases)
    seqs = (
        itertools.permutations(aliases)
        if n <= 7
        else [tuple(aliases)]  # degenerate fallback; workloads are small
    )
    for seq in seqs:
        est = run(seq)
        if est is not None and (best is None or est.cost < best.cost):
            best = est
    assert best is not None, f"no connected order for {query.name}"
    return best


def step_expansions(
    db: Database, query: JoinQuery, order: Sequence[str]
) -> List[float]:
    """Estimated *first-condition* output cardinality of each join step.

    The static-capacity executor sorts/probes on the first equality
    condition of a step and applies any further conditions as post-filters,
    so the capacity an intermediate buffer needs is the first-condition-only
    expansion — potentially much larger than the all-conditions estimate
    that drives :func:`estimate_query`.  Returns one estimate per join step
    along ``order`` (the pipeline compiler pow-2-buckets these); the running
    estimate fed into later steps does use every condition, matching what
    the post-filters leave behind.
    """
    scans = {r.alias: scan_estimate(db, r) for r in query.relations}
    cur = scans[order[0]]
    cur = RelEstimate(cur.rows, cur.width, dict(cur.ndv))
    out: List[float] = []
    for a, conds, closing in join_schedule(query, order):
        new = scans[a]
        cap_rows, _ = _join_card(cur, new, conds[:1], a)
        out.append(cap_rows)
        rows, ndv = _join_card(cur, new, conds, a)
        cur = RelEstimate(rows, cur.width + new.width, ndv)
        for c in closing:
            lv = cur.col_ndv(c.left, c.lcol)
            rv = cur.col_ndv(c.right, c.rcol)
            cur.rows = max(1.0, cur.rows / max(lv, rv))
    return out


def view_stats_from_estimate(est: QueryEstimate) -> TableStats:
    """Estimated stats attached to a view when it is materialized."""
    distinct = {f"{a}.{c}": int(max(1, v)) for (a, c), v in est.ndv.items()}
    return TableStats(rows=int(max(1, est.rows)), distinct=distinct,
                      width=est.width)


def view_cost(est: QueryEstimate) -> float:
    """Join(V) + A_D * N_P(V) of Eq 5 (+ materialization operator floor)."""
    return est.cost + A_D * est.rows * est.width * 4.0 + C_FIXED
