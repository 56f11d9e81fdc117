"""EXPLAIN / EXPLAIN ANALYZE plan reports: pure data + rendering.

The engine assembles a :class:`PlanReport` from planner and compiler
state (`ExtractionEngine.explain` / `explain_analyze`); this module only
defines the report structure and its text/JSON renderings so it can sit
at the bottom of the dependency stack with the rest of
``repro_torch.obs`` (``core`` imports ``obs``, never the other way
around).  The structure and renderings are the JAX package's.

A report answers the questions the paper's hybrid optimizer raises but a
returned graph hides:

* which join order Algorithm 2 chose for every plan unit,
* whether sharable subqueries became a materialized view (JS-MV) or an
  outer-join merge (JS-OJ), with the Eq. 1-5 cost numbers behind the
  decision (chosen plan vs. the no-sharing baseline),
* the pow-2 capacity bucket of every join step and whether the bucket
  came from a proven prior run or a fresh cost-model estimate,
* the unit-cache state (is the built unit function cached, or would the
  first run build it?),
* and — after ANALYZE — estimated vs. *actual* rows per step plus
  capacity utilization, read back from the host-side overflow-check
  values the pipeline already synced (zero added device round-trips).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["StepReport", "UnitReport", "PlanReport"]


@dataclasses.dataclass(frozen=True)
class StepReport:
    """One join step of a unit's chain — one pow-2 capacity bucket."""

    label: str                        # e.g. "join item", "outer-join b0"
    capacity: int                     # pow-2 buffer rows allotted
    est_rows: float                   # cost-model estimate (Eq. 1-3)
    actual_rows: Optional[int] = None  # ANALYZE only; host-side, no sync

    @property
    def utilization(self) -> Optional[float]:
        """actual / capacity — how full the bucket ran (None w/o ANALYZE)."""
        if self.actual_rows is None or self.capacity <= 0:
            return None
        return self.actual_rows / self.capacity

    @property
    def estimate_ratio(self) -> Optional[float]:
        """(actual+1)/(est+1) — >1 means the estimator undershot."""
        if self.actual_rows is None:
            return None
        return (self.actual_rows + 1.0) / (self.est_rows + 1.0)

    def to_json(self) -> Dict[str, object]:
        return {"label": self.label,
                "capacity": int(self.capacity),
                "est_rows": float(self.est_rows),
                "actual_rows": self.actual_rows,
                "utilization": self.utilization,
                "estimate_ratio": self.estimate_ratio}


@dataclasses.dataclass(frozen=True)
class UnitReport:
    """One plan unit (or one materialized view build)."""

    name: str
    kind: str                          # "view" | "edges" | "merged"
    inputs: Tuple[str, ...]            # tables/views the program reads
    join_orders: Tuple[Tuple[str, ...], ...]
    capacities: Tuple[int, ...]
    est_cost: float                    # cost-model byte-units
    executable: str                    # "cached"|"uncompiled"|"unknown"|"eager"
    capacity_source: str               # "programs"|"memo"|"estimated"
    steps: Tuple[StepReport, ...] = ()
    members: Tuple[str, ...] = ()      # merged units: member edge labels

    def describe_order(self) -> str:
        return " ; ".join(" -> ".join(order) for order in self.join_orders
                          if order)

    def to_json(self) -> Dict[str, object]:
        return {"name": self.name, "kind": self.kind,
                "inputs": list(self.inputs),
                "join_orders": [list(o) for o in self.join_orders],
                "capacities": [int(c) for c in self.capacities],
                "est_cost": float(self.est_cost),
                "executable": self.executable,
                "capacity_source": self.capacity_source,
                "steps": [s.to_json() for s in self.steps],
                "members": list(self.members)}


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """The full EXPLAIN (ANALYZE) report for one model + method."""

    model: str
    method: str
    epoch: int
    analyzed: bool
    plan_cache_hit: bool
    cost_plan: float                   # chosen hybrid plan (Eq. 5)
    cost_baseline: float               # no-sharing plan: one unit per query
    views: Tuple[UnitReport, ...]      # JS-MV builds, in materialize order
    reused_views: Tuple[Dict[str, object], ...]   # cached MVs: free
    units: Tuple[UnitReport, ...]      # edge / merged (JS-OJ) units
    timings_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def sharing_speedup(self) -> float:
        """Baseline-over-chosen cost ratio: the optimizer's claimed win."""
        return self.cost_baseline / self.cost_plan if self.cost_plan else 1.0

    def to_json(self) -> Dict[str, object]:
        return {"model": self.model, "method": self.method,
                "epoch": int(self.epoch), "analyzed": self.analyzed,
                "plan_cache_hit": self.plan_cache_hit,
                "cost_plan": float(self.cost_plan),
                "cost_baseline": float(self.cost_baseline),
                "sharing_speedup": float(self.sharing_speedup),
                "views": [v.to_json() for v in self.views],
                "reused_views": [dict(v) for v in self.reused_views],
                "units": [u.to_json() for u in self.units],
                "timings_s": dict(self.timings_s)}

    # -- text rendering ------------------------------------------------------
    def render_text(self) -> str:
        """ASCII tree, one entry per view/unit, one row per join step."""
        lines = [
            f"PLAN model={self.model} method={self.method} "
            f"epoch={self.epoch} "
            f"plan_cache={'hit' if self.plan_cache_hit else 'miss'}"
            + ("  (ANALYZE)" if self.analyzed else ""),
            f"cost={self.cost_plan:.4g} byte-units "
            f"(no-sharing baseline {self.cost_baseline:.4g}, "
            f"{self.sharing_speedup:.2f}x shared)",
        ]
        entries = []
        for rv in self.reused_views:
            entries.append([
                f"MV {rv['name']} [reused: free]  "
                f"tables={','.join(rv.get('tables', ()))}  "
                f"rows~{rv.get('rows_est', 0):.0f}"])
        for v in self.views:
            entries.append(_entry_lines(v, tag="MV"))
        for u in self.units:
            entries.append(_entry_lines(u, tag="UNIT"))
        for i, entry in enumerate(entries):
            last = i == len(entries) - 1
            lines.append(("`- " if last else "|- ") + entry[0])
            pad = "   " if last else "|  "
            lines.extend(pad + sub for sub in entry[1:])
        if self.timings_s:
            lines.append("timings: " + "  ".join(
                f"{k}={v:.3f}s" for k, v in sorted(self.timings_s.items())))
        return "\n".join(lines)


def _entry_lines(u: UnitReport, tag: str) -> list:
    head = (f"{tag} {u.name} [{u.kind}]  cost={u.est_cost:.4g}  "
            f"exe={u.executable}  capacities={u.capacity_source}")
    lines = [head]
    order = u.describe_order()
    if order:
        lines.append(f"  order: {order}")
    if u.members:
        lines.append("  members: " + ", ".join(u.members))
    for i, s in enumerate(u.steps):
        row = (f"  #{i + 1} {s.label:<26} cap={s.capacity:<8d} "
               f"est={s.est_rows:<12.1f}")
        if s.actual_rows is not None:
            row += (f" actual={s.actual_rows:<8d} "
                    f"util={s.utilization:.2f} "
                    f"ratio={s.estimate_ratio:.2f}")
        lines.append(row)
    return lines
