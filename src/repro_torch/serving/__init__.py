# Multi-tenant serving layer over the extraction engine: async request
# scheduling with single-flight coalescing, epoch-based MVCC snapshots
# (readers never block on — or observe torn state from — the writer
# building the next epoch), and per-tenant admission quotas + response
# caches.  The HTTP front end lives in examples/serve_graphs_torch.py.
from repro_torch.serving.quotas import (
    QuotaExceeded,
    QuotaManager,
    TenantQuota,
)
from repro_torch.serving.scheduler import (
    AdmissionError,
    CoalescingScheduler,
    DeadlineExceeded,
    ServiceClosed,
)
from repro_torch.serving.service import (
    DEFAULT_TENANT,
    GraphService,
    UnknownModel,
)
from repro_torch.serving.snapshots import (
    Snapshot,
    SnapshotNotFound,
    SnapshotStore,
)

__all__ = [
    "GraphService",
    "DEFAULT_TENANT",
    "UnknownModel",
    "CoalescingScheduler",
    "AdmissionError",
    "DeadlineExceeded",
    "ServiceClosed",
    "QuotaManager",
    "TenantQuota",
    "QuotaExceeded",
    "Snapshot",
    "SnapshotStore",
    "SnapshotNotFound",
]
