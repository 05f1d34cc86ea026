"""Core library: the paper's asymmetric mutual exclusion, faithfully, plus its
adaptation to a GPU cluster's two fabrics.

Control plane (simulated RDMA, host-level), copied module for module from the
JAX package's ``core``, which is the reference:
    AsymmetricMemory, Process, OpCounts — operation-asymmetric registers
    ALock                              — the paper's primitive (Alg. 1 + 2)
    NaiveRCASLock / RPCLock / FilterLock — the paper's comparison points

Data plane (``torch.distributed``, multi-pod), ported from the reference:
    cohort_all_reduce / flat_all_reduce — hierarchical vs flat schedules
    SyncConfig, pod_sync_grads, pod_average_params
    H100 and the asymmetry cost model

Model checker (``modelcheck``), copied from the reference: an explicit-state
check of the PlusCal spec (paper Appendix A).
"""

from .memory import (  # noqa: F401
    NULLPTR,
    TIMEOUT,
    AsymmetricMemory,
    DeadlineExceeded,
    OpCounts,
    OperationNotEnabled,
    Overloaded,
    Process,
    Register,
    RemoteTimeout,
    make_scheduler,
)
from .mcs import BudgetedMCSLock, InflatedKeyQueue  # noqa: F401
from .peterson import ModifiedPetersonLock  # noqa: F401
from .alock import (  # noqa: F401
    ALock,
    BrokenMixedCASLock,
    FilterLock,
    NaiveRCASLock,
    RPCLock,
)
from .asymmetry import (  # noqa: F401
    H100,
    all_gather_wire_bytes,
    all_to_all_wire_bytes,
    allreduce_wire_bytes,
    cohort_vs_flat_dcn_bytes,
    reduce_scatter_wire_bytes,
)
from .cohort import (  # noqa: F401
    SyncConfig,
    cohort_all_reduce,
    flat_all_reduce,
    pod_average_params,
    pod_sync_grads,
)
from . import modelcheck  # noqa: F401
