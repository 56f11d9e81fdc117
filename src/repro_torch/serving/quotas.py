"""Per-tenant quotas: in-flight admission + LRU-bounded response caches.

Engine caches (plans, views, CSRs, executables) are *shared* and
content-addressed — tenants asking for the same graph ride the same
entries, which is the whole point of coalescing.  What must NOT be shared
is the budget: one tenant hammering thousands of distinct models may not
evict another tenant's warm responses or monopolize the worker pool.  So
each tenant gets

* an **in-flight cap** (``max_inflight``) — the (K+1)-th concurrent
  request of one tenant is rejected with a retry hint while other tenants
  keep being admitted, and
* a **private response LRU** (``max_entries`` / ``max_bytes``) —
  pressure-driven eviction is per tenant, so cache thrash never crosses
  tenant boundaries.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Hashable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Budget of one tenant (the default applies to unknown tenants)."""

    max_inflight: int = 8        # concurrent admitted requests
    max_entries: int = 64        # response-cache entries
    max_bytes: int = 64 << 20    # response-cache payload budget


class QuotaExceeded(RuntimeError):
    """The tenant's in-flight budget is spent; retry after backoff."""

    def __init__(self, tenant: str, inflight: int, quota: TenantQuota,
                 retry_after: float = 0.05):
        super().__init__(
            f"tenant {tenant!r} at in-flight quota "
            f"({inflight}/{quota.max_inflight})")
        self.tenant = tenant
        self.retry_after = retry_after


class _TenantState:
    __slots__ = ("quota", "inflight", "cache", "cache_bytes",
                 "hits", "misses", "evictions", "rejections", "admitted")

    def __init__(self, quota: TenantQuota):
        self.quota = quota
        self.inflight = 0
        # key -> (payload, nbytes); access-ordered LRU
        self.cache: "collections.OrderedDict[Hashable, Tuple[object, int]]" \
            = collections.OrderedDict()
        self.cache_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejections = 0
        self.admitted = 0


class QuotaManager:
    """Admission + response caching, partitioned by tenant."""

    def __init__(self, default: Optional[TenantQuota] = None,
                 per_tenant: Optional[Dict[str, TenantQuota]] = None):
        self.default = default or TenantQuota()
        self._overrides = dict(per_tenant or {})
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = _TenantState(self._overrides.get(tenant, self.default))
            self._tenants[tenant] = st
        return st

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._overrides[tenant] = quota
            st = self._tenants.get(tenant)
            if st is not None:
                st.quota = quota
                self._evict_locked(st)

    # -- admission -----------------------------------------------------------
    def admit(self, tenant: str) -> None:
        """Reserve one in-flight slot; raises :class:`QuotaExceeded`."""
        with self._lock:
            st = self._state(tenant)
            if st.inflight >= st.quota.max_inflight:
                st.rejections += 1
                raise QuotaExceeded(tenant, st.inflight, st.quota)
            st.inflight += 1
            st.admitted += 1

    def release(self, tenant: str) -> None:
        with self._lock:
            st = self._state(tenant)
            st.inflight = max(0, st.inflight - 1)

    # -- per-tenant response cache -------------------------------------------
    def cached(self, tenant: str, key: Hashable):
        """The tenant's cached response for ``key`` (LRU touch), or None."""
        with self._lock:
            st = self._state(tenant)
            hit = st.cache.get(key)
            if hit is None:
                st.misses += 1
                return None
            st.cache.move_to_end(key)
            st.hits += 1
            return hit[0]

    def record(self, tenant: str, key: Hashable, payload: object,
               nbytes: int) -> None:
        """Store a response against the tenant's budget; evicts LRU-first.

        Eviction only ever touches *this* tenant's entries — pressure from
        one tenant cannot push out another tenant's warm responses.
        """
        with self._lock:
            st = self._state(tenant)
            old = st.cache.pop(key, None)
            if old is not None:
                st.cache_bytes -= old[1]
            st.cache[key] = (payload, int(nbytes))
            st.cache_bytes += int(nbytes)
            self._evict_locked(st)

    def _evict_locked(self, st: _TenantState) -> None:
        while st.cache and (len(st.cache) > st.quota.max_entries
                            or st.cache_bytes > st.quota.max_bytes):
            _, (_, nb) = st.cache.popitem(last=False)
            st.cache_bytes -= nb
            st.evictions += 1

    def invalidate(self, tenant: Optional[str] = None) -> None:
        """Drop response caches (all tenants, or one)."""
        with self._lock:
            targets = ([self._tenants[tenant]] if tenant in self._tenants
                       else []) if tenant is not None \
                else list(self._tenants.values())
            for st in targets:
                st.cache.clear()
                st.cache_bytes = 0

    def stats(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {
                name: {
                    "inflight": st.inflight,
                    "admitted": st.admitted,
                    "rejections": st.rejections,
                    "cache_entries": len(st.cache),
                    "cache_bytes": st.cache_bytes,
                    "hits": st.hits,
                    "misses": st.misses,
                    "evictions": st.evictions,
                    "quota": dataclasses.asdict(st.quota),
                }
                for name, st in self._tenants.items()
            }
