"""Host-level coordination built on the paper's ALock (control plane).

``ShardedLockTable`` spreads lock shards over every host so the paper's
per-class cost optimality covers the whole keyspace; ``CoordinationService``
wraps it together with named locks, elections and barriers.  The failover
stack (``membership`` + ``takeover_shard``) keeps the table self-healing:
lease-based heartbeats detect dead homes and the deterministic successor
re-homes their shards under an epoch fence.
"""

from .faults import (CRASH_POINTS, FABRIC_POINTS, ClientCrash,  # noqa: F401
                     FaultInjector)
from .inflation import ContentionEstimator, InflationPolicy  # noqa: F401
from .ledger import (LeaseLedger, LedgerRecord, LedgerStore,  # noqa: F401
                     LedgerView, RecoverableClient, replay_records)
from .membership import (ALIVE, DEAD, SUSPECT, HostMembership,  # noqa: F401
                         SuspicionEstimator, SuspicionPolicy, member_key_for)
from .overload import (CircuitBreaker, LatencyTracker,  # noqa: F401
                       OverloadControl, OverloadPolicy, RetryBudget)
from .pipeline import AsyncClient, PipelineFuture  # noqa: F401
from .service import Barrier, CoordinationService  # noqa: F401
from .table import (Lease, LeaseMode, LockShard, ShardedLockTable,  # noqa: F401
                    forwarded_home, stable_key_hash)
