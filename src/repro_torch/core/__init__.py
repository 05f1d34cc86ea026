"""Core library: the paper's asymmetric mutual exclusion, faithfully.

Control plane (simulated RDMA, host-level), copied module for module from the
JAX package's ``core``, which is the reference:
    AsymmetricMemory, Process, OpCounts — operation-asymmetric registers
    ALock                              — the paper's primitive (Alg. 1 + 2)
    NaiveRCASLock / RPCLock / FilterLock — the paper's comparison points

The reference's data-plane modules (``cohort``, ``asymmetry``) and its model
checker (``modelcheck``) are not part of the port yet.
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
