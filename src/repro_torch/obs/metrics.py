"""Process-wide metrics registry: counters, gauges, bounded histograms.

The observability contract of the repo (GraphGen made cost estimates a
user-facing artifact; GQ-Fast accounts for every decode cycle — our
numbers deserve the same treatment): every layer reports into **one**
process-wide registry instead of keeping bespoke stat dicts, and the
registry is exportable as a JSON snapshot or Prometheus text format so a
live server can be scraped.

Design constraints, in order:

* **Always-on and cheap.**  A counter increment is one short-held lock and
  an integer add (~0.2 µs); a histogram observation is a ``frexp`` bucket
  index into a *fixed-size* array.  Nothing here ever touches a device or
  allocates per observation.
* **Bounded memory.**  Histograms keep log₂-spaced bucket counts (one
  ``int`` per power of two across ~19 decades), never raw samples —
  p50/p95/p99 are estimated from the cumulative bucket counts with
  geometric interpolation, accurate to the bucket width (≤ 2x), which is
  plenty for "where did the time go" questions.
* **Exact under concurrency.**  Every child metric owns a lock; two
  threads bumping the same counter never lose an increment (CPython's
  ``+=`` on an attribute is not atomic).

Metric children are identified by (family name, sorted label items) — the
Prometheus data model — e.g.::

    REGISTRY.counter("engine_cache_events_total",
                     cache="plans", event="hit").inc()

Families are typed: re-registering a name as a different kind raises.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter (float-valued so it can accumulate seconds)."""

    __slots__ = ("labels", "_lock", "_value")

    def __init__(self, labels: LabelItems):
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (queue depth, EWMA estimate, ...)."""

    __slots__ = ("labels", "_lock", "_value")

    def __init__(self, labels: LabelItems):
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


# Bucket i counts observations in (2**(i+LOW_EXP-1), 2**(i+LOW_EXP)];
# 2**-30 (~1 ns) .. 2**32 (~4e9) covers latencies in seconds and row
# counts alike.  Values at or below 0 land in the underflow bucket, values
# beyond the top land in the overflow bucket — memory is bounded by
# construction, whatever is observed.
_LOW_EXP = -30
_HIGH_EXP = 32
_NBUCKETS = _HIGH_EXP - _LOW_EXP


class Histogram:
    """Bounded-memory log₂ histogram with estimated quantiles."""

    __slots__ = ("labels", "_lock", "_buckets", "_under", "_over",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, labels: LabelItems):
        self.labels = labels
        self._lock = threading.Lock()
        self._buckets = [0] * _NBUCKETS
        self._under = 0
        self._over = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if value <= 0.0:
                self._under += 1
                return
            # frexp(v) = (m, e) with v = m * 2**e, 0.5 <= m < 1, so v lands
            # in bucket (2**(e-1), 2**e]  ->  index e - LOW_EXP (exact
            # powers of two have m == 0.5 and belong to the lower bucket).
            m, e = math.frexp(value)
            if m == 0.5:
                e -= 1
            idx = e - _LOW_EXP
            if idx < 0:
                self._under += 1
            elif idx >= _NBUCKETS:
                self._over += 1
            else:
                self._buckets[idx] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (geometric midpoint of its bucket)."""
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q * self._count
            seen = self._under
            if rank <= seen:
                return self._min if math.isfinite(self._min) else 0.0
            for i, c in enumerate(self._buckets):
                if not c:
                    continue
                seen += c
                if rank <= seen:
                    lo = 2.0 ** (i + _LOW_EXP - 1)
                    hi = 2.0 ** (i + _LOW_EXP)
                    return min(max(math.sqrt(lo * hi), self._min), self._max)
            return self._max if math.isfinite(self._max) else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if math.isfinite(self._min) else 0.0
            mx = self._max if math.isfinite(self._max) else 0.0
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "mean": (total / count) if count else 0.0,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def nonempty_buckets(self) -> List[Tuple[float, int]]:
        """(upper bound, cumulative count) for Prometheus ``le`` series."""
        out: List[Tuple[float, int]] = []
        with self._lock:
            cum = self._under
            if self._under:
                out.append((2.0 ** (_LOW_EXP - 1), cum))
            for i, c in enumerate(self._buckets):
                if c:
                    cum += c
                    out.append((2.0 ** (i + _LOW_EXP), cum))
        return out


class _Family:
    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: Dict[LabelItems, object] = {}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe registry of typed, labeled metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _child(self, kind: str, name: str, help: str,
               labels: Dict[str, object]):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            child = fam.children.get(key)
            if child is None:
                child = _KINDS[kind](key)
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._child("histogram", name, help, labels)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def value(self, name: str, **labels) -> float:
        """Current value of one counter/gauge child (0.0 if absent)."""
        fam = self.get(name)
        if fam is None:
            return 0.0
        child = fam.children.get(_label_key(labels))
        return 0.0 if child is None else float(child.value)

    def reset(self) -> None:
        """Drop every family — test isolation only."""
        with self._lock:
            self._families.clear()

    # -- export --------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready view: {family: {type, help, series: [...]}}."""
        with self._lock:
            families = {n: (f.kind, f.help, dict(f.children))
                        for n, f in self._families.items()}
        out: Dict[str, Dict] = {}
        for name in sorted(families):
            kind, help, children = families[name]
            series = []
            for key in sorted(children):
                child = children[key]
                entry: Dict[str, object] = {"labels": dict(key)}
                if kind == "histogram":
                    entry.update(child.snapshot())
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[name] = {"type": kind, "help": help, "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            families = {n: (f.kind, f.help, dict(f.children))
                        for n, f in self._families.items()}
        lines: List[str] = []
        for name in sorted(families):
            kind, help, children = families[name]
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for key in sorted(children):
                child = children[key]
                if kind == "histogram":
                    for le, cum in child.nonempty_buckets():
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(key, ('le', _fmt_num(le)))} {cum}")
                    lines.append(
                        f"{name}_bucket{_fmt_labels(key, ('le', '+Inf'))} "
                        f"{child.count}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} {_fmt_num(child.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {child.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(key)} {_fmt_num(child.value)}")
        return "\n".join(lines) + "\n"


def _fmt_num(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(key: LabelItems, *extra: Tuple[str, str]) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items)
    return "{" + body + "}"


#: The process-wide default registry every instrumented layer reports to.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


# -- failure / recovery metric families ---------------------------------------
# The robustness layer's counters, named in one place so every emitter
# (scheduler, service, WAL, recovery, fault injector) uses the same family
# name and help string, and dashboards can enumerate the full set.
FAILURE_FAMILIES: Dict[str, str] = {
    "serving_deadline_exceeded_total":
        "Requests failed by their per-request deadline.",
    "serving_retries_total":
        "Bounded retries of retryable failures, by operation.",
    "serving_refresh_failures_total":
        "Failed epoch builds (discarded; previous epoch kept serving).",
    "serving_persist_failures_total":
        "Durability persists that failed after a successful publish.",
    "serving_closed_rejections_total":
        "Requests rejected because the service is closing.",
    "durability_wal_records_total":
        "Records appended to the write-ahead log.",
    "durability_wal_truncated_records_total":
        "Torn-tail bytes-discarding truncations during WAL replay.",
    "durability_recoveries_total":
        "Warm restarts recovered from a durable_dir, by path.",
    "durability_faults_injected_total":
        "Faults fired by the injection harness, by site and action.",
}


def failure_counter(name: str, **labels) -> Counter:
    """A counter from the registered failure-family catalogue.

    Guards against typo'd family names drifting out of the catalogue —
    new failure counters must be declared in :data:`FAILURE_FAMILIES`.
    """
    if name not in FAILURE_FAMILIES:
        raise KeyError(f"{name!r} is not a declared failure family "
                       f"(have {sorted(FAILURE_FAMILIES)})")
    return REGISTRY.counter(name, help=FAILURE_FAMILIES[name], **labels)
