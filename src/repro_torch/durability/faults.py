"""Deterministic fault injection for the durability and serving stack.

Every failure path the robustness layer claims to survive must be
*exercisable* in the tests — not just reasoned about.  This module gives
the WAL and the engine named **fault sites**; a test installs a
:class:`FaultPlan` and the next matching site firing injects the planned
failure.  Everything is deterministic: rules fire by match count, never by
random draw, so a failing fault-matrix case replays exactly.

Sites threaded through this package::

    wal.append           partial/failed record write (torn tail)
    wal.fsync            fsync failure after a fully-written record
    wal.rename           segment-seal / atomic-commit rename failure
    engine.cache_fill    engine-cache insert failure after a build

The JAX package's serving layer adds ``snapshot.publish``,
``scheduler.worker`` and ``refresh.midflight``; a plan naming them is
accepted here and never fires.  Plans are the same JSON in both packages.

Usage::

    from repro_torch.durability import faults

    with faults.inject(faults.FaultRule("wal.fsync", times=1)):
        db.insert_rows(...)        # first fsync raises FaultInjected

Actions: ``raise`` (a retryable :class:`FaultInjected`), ``raise_fatal``
(a non-retryable :class:`FatalFaultInjected` — the "unexpected bug"
stand-in), ``delay`` (sleep ``delay_s``, then proceed), ``partial``
(consumed by byte-writers via :func:`partial`: write only ``fraction`` of
the record, then raise).  ``after`` skips the first N matches; ``times``
bounds how often a rule fires before burning out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import json
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.obs.metrics import failure_counter


class RetryableError(RuntimeError):
    """A transient failure: the operation is safe to retry after backoff.

    The serving layer's bounded retry loop (and the HTTP front end's
    ``retryable: true`` error bodies) key off this type.
    """

    def __init__(self, message: str, retry_after: float = 0.05):
        super().__init__(message)
        self.retry_after = retry_after


class FaultInjected(RetryableError):
    """Raised by a fired ``raise``/``partial``/``fsync`` fault rule."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site!r}")
        self.site = site


class FatalFaultInjected(RuntimeError):
    """Injected *non*-retryable failure (stands in for an unexpected bug)."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fatal fault at {site!r}")
        self.site = site


@dataclasses.dataclass
class FaultRule:
    """One planned failure: where, what, and how often.

    ``site`` is an ``fnmatch`` glob (``"wal.*"`` matches every WAL site).
    A rule *matches* whenever its site fires; it *fires* only after
    skipping the first ``after`` matches, and at most ``times`` times.
    """

    site: str
    action: str = "raise"        # raise | raise_fatal | delay | partial
    times: int = 1
    after: int = 0
    delay_s: float = 0.0
    fraction: float = 0.5        # partial-write prefix fraction
    message: str = ""
    matched: int = 0             # runtime counters, not plan identity
    fired: int = 0

    _ACTIONS = ("raise", "raise_fatal", "delay", "partial")

    def __post_init__(self):
        if self.action not in self._ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(have {self._ACTIONS})")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], "
                             f"got {self.fraction}")

    def exhausted(self) -> bool:
        return self.fired >= self.times

    def spec(self) -> Dict[str, object]:
        return {"site": self.site, "action": self.action,
                "times": self.times, "after": self.after,
                "delay_s": self.delay_s, "fraction": self.fraction,
                "message": self.message}


@dataclasses.dataclass
class FaultPlan:
    """An ordered rule list; the first applicable rule consumes each event.

    ``seed`` is recorded for provenance (plans are replayed by match
    count, so two runs of the same plan against the same workload fire
    identically — the seed names the scenario, it does not drive an RNG).
    """

    rules: List[FaultRule] = dataclasses.field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_json(cls, source: Union[str, Dict]) -> "FaultPlan":
        """Build a plan from a JSON string or already-parsed dict.

        Accepts ``{"rules": [{...}], "seed"?: int}`` or a bare rule list.
        """
        data = json.loads(source) if isinstance(source, str) else source
        if isinstance(data, list):
            data = {"rules": data}
        rules = [FaultRule(**r) for r in data.get("rules", [])]
        return cls(rules=rules, seed=int(data.get("seed", 0)))

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.spec() for r in self.rules]})


class FaultInjector:
    """Process-wide registry of the installed plan plus firing log."""

    def __init__(self):
        self._lock = threading.RLock()
        self._plan: Optional[FaultPlan] = None
        self.fired_log: List[str] = []

    # -- plan lifecycle ------------------------------------------------------
    def install(self, plan: Optional[FaultPlan]) -> None:
        with self._lock:
            self._plan = plan
            self.fired_log = []

    def uninstall(self) -> None:
        self.install(None)

    @contextlib.contextmanager
    def inject(self, *rules: Union[FaultRule, FaultPlan]
               ) -> Iterator["FaultInjector"]:
        """Scoped install: ``with faults.inject(rule, ...):`` (test helper)."""
        if len(rules) == 1 and isinstance(rules[0], FaultPlan):
            plan = rules[0]
        else:
            plan = FaultPlan(rules=list(rules))
        with self._lock:
            previous = self._plan
        self.install(plan)
        try:
            yield self
        finally:
            self.install(previous)

    def active(self) -> bool:
        with self._lock:
            return self._plan is not None and any(
                not r.exhausted() for r in self._plan.rules)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            if self._plan is None:
                return {"installed": False, "fired": list(self.fired_log)}
            return {"installed": True, "seed": self._plan.seed,
                    "rules": [dict(r.spec(), matched=r.matched,
                                   fired=r.fired)
                              for r in self._plan.rules],
                    "fired": list(self.fired_log)}

    # -- firing --------------------------------------------------------------
    def _arm(self, site: str, actions: Tuple[str, ...]
             ) -> Optional[FaultRule]:
        """First matching rule of the wanted action class, advanced."""
        with self._lock:
            plan = self._plan
            if plan is None:
                return None
            for rule in plan.rules:
                if rule.action not in actions:
                    continue
                if not fnmatch.fnmatch(site, rule.site):
                    continue
                rule.matched += 1
                if rule.matched <= rule.after or rule.exhausted():
                    return None
                rule.fired += 1
                self.fired_log.append(f"{site}:{rule.action}")
                failure_counter("durability_faults_injected_total",
                                site=site, action=rule.action).inc()
                return rule
            return None

    def fire(self, site: str) -> None:
        """Raise/delay if the plan has an armed rule for ``site``.

        Byte-writers must *also* consult :meth:`partial` — ``fire`` only
        handles the raise/delay action classes.
        """
        rule = self._arm(site, ("raise", "raise_fatal", "delay"))
        if rule is None:
            return
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return
        if rule.action == "raise_fatal":
            raise FatalFaultInjected(site, rule.message)
        raise FaultInjected(site, rule.message)

    def partial(self, site: str) -> Optional[float]:
        """Prefix fraction to write before failing, if a partial rule fires.

        The *writer* owns the torn-write mechanics: write
        ``int(len * fraction)`` bytes, flush, then raise
        :class:`FaultInjected` — exactly what a crash mid-``write`` leaves
        on disk.
        """
        rule = self._arm(site, ("partial",))
        return None if rule is None else rule.fraction


#: The process-wide injector every instrumented site consults.
INJECTOR = FaultInjector()

install = INJECTOR.install
uninstall = INJECTOR.uninstall
inject = INJECTOR.inject
fire = INJECTOR.fire
partial = INJECTOR.partial
