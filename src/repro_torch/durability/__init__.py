# Durability + recovery + fault injection: a crash-safe WAL under the live
# database's change capture, manifest + checkpoint warm restarts verified
# by bag-digest parity, and a deterministic fault-injection harness so
# every failure path is exercisable in the tests.  The on-disk formats are
# the JAX package's.
from repro_torch.durability import faults  # noqa: F401
from repro_torch.durability.faults import (
    FatalFaultInjected,
    FaultInjected,
    FaultPlan,
    FaultRule,
    INJECTOR,
    RetryableError,
)
from repro_torch.durability.recovery import (
    RecoveryError,
    RecoveryReport,
    load_manifest,
    recover_database,
    replay_wal,
    restore_database,
    write_manifest,
)
from repro_torch.durability.wal import (
    WALCorruption,
    WALError,
    WALRecord,
    WriteAheadLog,
    read_all,
)

__all__ = [
    "faults",
    "FaultPlan",
    "FaultRule",
    "FaultInjected",
    "FatalFaultInjected",
    "RetryableError",
    "INJECTOR",
    "WriteAheadLog",
    "WALRecord",
    "WALError",
    "WALCorruption",
    "read_all",
    "RecoveryError",
    "RecoveryReport",
    "write_manifest",
    "load_manifest",
    "restore_database",
    "replay_wal",
    "recover_database",
]
